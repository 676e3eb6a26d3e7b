"""Shared settings of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds (the configuration's shapes otherwise)."""
import pytest
import torch

TINY = {"particles": 32, "bases": 64, "horizon": 0.5, "drift": {"num_inducing": 24},
        "policy": {"num_inducing": 8}}


@pytest.fixture
def tiny():
    torch.set_num_threads(2)
    return TINY
