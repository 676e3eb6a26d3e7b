"""Cartpole swing-up success for the PyTorch port (the torch twin of
``experiment.py``'s ``success_mask``), and the episode metrics that
``run_torch.py`` registers."""
from __future__ import annotations

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from gpflowpilco_torch.loops.metrics import holds_for, task_metrics  # noqa: E402


def success_mask(env, states: torch.Tensor, prox_threshold: float = 0.2, num_consecutive: int = 10):
    """Whether the pole tip stays within ``prox_threshold`` pole-lengths of
    the upright goal for at least ``num_consecutive`` consecutive steps:
    states (..., T+1, D) -> bool (...)."""
    radius = env.pole_height
    x, y = env.get_tip_coordinates(states)
    return holds_for(torch.sqrt(x**2 + (y - radius) ** 2) < prox_threshold * radius, num_consecutive)


def _success(loop, states):
    return success_mask(loop.env, states)


def episode_metrics(validation_samples: int = 100) -> dict:
    """The swing-up's episode metrics, as ``experiment.py`` registers them:
    the realized reward, success, the model-predicted reward and, unless
    ``validation_samples`` is 0, validation (vReward, vSuccess)."""
    return task_metrics(_success, validation_samples)
