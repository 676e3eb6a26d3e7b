"""Episode metrics (counterpart of gpflowpilco_tpu/loops/metrics.py).

The batched 100-rollout validation metrics are not ported yet.
"""
from __future__ import annotations

import torch


def metric_rewards(loop, states, actions):
    """Realized episode reward: -sum of per-step objective costs over the
    encoded trajectory."""
    feats = loop.encode(torch.as_tensor(states, dtype=loop.dtype, device=loop.device))
    return float(-torch.sum(loop.objective(feats)))


def metric_expected_reward(loop, states, actions):
    """Model-predicted expected reward of the freshly trained policy."""
    return loop.expected_reward()


def make_validation_metrics(success_fn=None, num_samples: int = 100):
    raise NotImplementedError("batched validation rollouts are not ported yet")
