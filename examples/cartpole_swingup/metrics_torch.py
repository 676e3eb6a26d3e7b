"""Cartpole swing-up success for the PyTorch port (the torch twin of
``experiment.py``'s ``success_mask``), and the episode metrics that
``run_torch.py`` registers."""
from __future__ import annotations

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from gpflowpilco_torch.loops.metrics import (  # noqa: E402
    make_success_metric,
    make_validation_metrics,
    metric_expected_reward,
    metric_rewards,
)


def success_mask(env, states: torch.Tensor, prox_threshold: float = 0.2, num_consecutive: int = 10):
    """Whether the pole tip stays within ``prox_threshold`` pole-lengths of
    the upright goal for at least ``num_consecutive`` consecutive steps:
    states (..., T+1, D) -> bool (...). A run's length in each window of
    ``num_consecutive`` steps comes from a cumulative sum, in integers."""
    radius = env.pole_height
    x, y = env.get_tip_coordinates(states)
    prox = torch.sqrt(x**2 + (y - radius) ** 2) < prox_threshold * radius  # (..., T+1)
    counts = torch.nn.functional.pad(torch.cumsum(prox.to(torch.int64), dim=-1), (1, 0))
    runs = counts[..., num_consecutive:] - counts[..., :-num_consecutive]
    return torch.any(runs >= num_consecutive, dim=-1)


def _success(loop, states):
    return success_mask(loop.env, states)


metric_success = make_success_metric(_success)


def episode_metrics(validation_samples: int = 100) -> dict:
    """The swing-up's episode metrics, as ``experiment.py`` registers them:
    the realized reward, success, the model-predicted reward and, unless
    ``validation_samples`` is 0, validation (vReward, vSuccess)."""
    metrics = {"rewards": metric_rewards, "success": metric_success, "eReward": metric_expected_reward}
    if validation_samples:
        metrics["validation"] = make_validation_metrics(_success, validation_samples)
    return metrics
