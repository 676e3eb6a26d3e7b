"""Episode metrics (counterpart of gpflowpilco_tpu/loops/metrics.py).

Validation scores the DEPLOYED controller (``loop.acting_model``): with the
retain_best_policy acting gate, the policy that acted may be the
best-validated snapshot rather than the freshly trained one. Its
``num_samples`` rollouts run as one batched RK4 rollout, the initial states
on a leading axis.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..envs.base import rollout as env_rollout
from .pilco import _VALIDATION


def deployed_policy(loop):
    """The controller that acted in the latest real episode (the trained
    policy or the best-validated snapshot), or the trained policy before any
    episode."""
    return loop.acting_model if loop.acting_model is not None else loop.policy_model


def metric_rewards(loop, states, actions):
    """Realized episode reward: -sum of per-step objective costs over the
    encoded trajectory."""
    feats = loop.encode(torch.as_tensor(states, dtype=loop.dtype, device=loop.device))
    return float(-torch.sum(loop.objective(feats)))


def metric_expected_reward(loop, states, actions):
    """Model-predicted expected reward of the freshly trained policy."""
    return loop.expected_reward()


def holds_for(flags: torch.Tensor, num_consecutive: int) -> torch.Tensor:
    """Whether ``flags`` (..., T) is true for ``num_consecutive`` steps in a
    row: bool (...). A run's length in each window comes from a cumulative
    sum, in integers."""
    counts = torch.nn.functional.pad(torch.cumsum(flags.to(torch.int64), dim=-1), (1, 0))
    runs = counts[..., num_consecutive:] - counts[..., :-num_consecutive]
    return torch.any(runs >= num_consecutive, dim=-1)


def make_success_metric(success_fn: Callable):
    """Boolean episode-success metric from a per-trajectory predicate
    ``success_fn(loop, states (T+1, D)) -> bool tensor``."""

    def metric_success(loop, states, actions):
        return bool(success_fn(loop, torch.as_tensor(states, dtype=loop.dtype, device=loop.device)))

    return metric_success


def validation_rollouts(loop, model, x0: torch.Tensor):
    """Roll ``model``'s squashed policy out in the real environment from
    each initial state of x0 (S, D), as one batched RK4 rollout. Returns
    (rewards (S,), states (S, T+1, D))."""
    spec = loop.episode_spec
    with torch.no_grad():
        chain = loop.policy_chain(model)
        states, _ = env_rollout(
            loop.env, lambda s: chain(loop.encode(s)), x0, spec.step_size, spec.num_steps,
            loop.env_substeps,
        )
        states = states.movedim(0, -2)  # (T+1, S, D) -> (S, T+1, D)
        rewards = -torch.sum(loop.objective(loop.encode(states)), dim=-1)
    return rewards, states


def make_validation_metrics(success_fn: Optional[Callable], num_samples: int = 100):
    """Real-environment validation of the deployed controller from
    ``num_samples`` initial states: ``vReward``, the mean reward, and, with
    ``success_fn``, ``vSuccess``, the share of successful rollouts.
    ``success_fn(loop, states (..., T+1, D)) -> bool (...)`` takes the
    rollouts on leading axes."""

    def validation(loop, states, actions):
        model = deployed_policy(loop)
        if model is None:
            out = {"vReward": float("nan")}
            if success_fn is not None:
                out["vSuccess"] = float("nan")
            return out
        x0 = loop.episode_spec.sample(
            loop.iteration_generator(_VALIDATION), (num_samples,), dtype=loop.dtype, device=loop.device
        )
        rewards, rollouts = validation_rollouts(loop, model, x0)
        out = {"vReward": float(rewards.mean())}
        if success_fn is not None:
            out["vSuccess"] = float(success_fn(loop, rollouts).to(loop.dtype).mean())
        return out

    return validation


def task_metrics(success_fn: Callable, validation_samples: int) -> dict:
    """A task's episode metrics: the realized reward, success by
    ``success_fn``, the model-predicted reward and, unless
    ``validation_samples`` is 0, validation (vReward, vSuccess)."""
    metrics = {
        "rewards": metric_rewards,
        "success": make_success_metric(success_fn),
        "eReward": metric_expected_reward,
    }
    if validation_samples:
        metrics["validation"] = make_validation_metrics(success_fn, validation_samples)
    return metrics
