"""Task-agnostic outer-loop driver (counterpart of gpflowpilco_tpu/loops/driver.py)."""
from __future__ import annotations

import logging

import numpy as np

from ..utils import tracing
from ..utils.summary import log_module_summary

logger = logging.getLogger("gpflowpilco_torch.driver")


def outer_loop(
    loop,
    num_episodes: int = 10,
    num_episodes_init: int = 1,
    save: bool = True,
    log_summaries: bool = True,
):
    """Alternate (fit dynamics, fit policy, collect episode) until
    ``num_episodes`` episodes exist; the first ``num_episodes_init`` episodes
    act randomly. With ``save``, ``loop.save()`` checkpoints after every
    episode (a no-op for a loop without a directory). Each phase is a span
    (``episode.dynamics``, ``episode.policy``, ``episode.rollout``); their
    seconds are logged per episode and summed at the end."""
    totals = {}
    while len(loop.episodes) < num_episodes:
        timings = {}
        if len(loop.episodes) >= num_episodes_init:
            with tracing.span("episode.dynamics") as phase:
                info = loop.update_dynamics()
            timings["dynamics_s"] = phase.seconds
            logger.info(
                "dynamics: loss=%.4f iters=%d (%.1fs)",
                info["loss"], info["iters"], timings["dynamics_s"],
            )
            if log_summaries:
                log_module_summary(loop.drift_model, "drift", logger)
            with tracing.span("episode.policy") as phase:
                info = loop.update_policy()
            timings["policy_s"] = phase.seconds
            logger.info(
                "policy: loss=%.5f nan_frac=%.3f skipped=%d best_restart=%s restart_losses=%s (%.1fs)",
                info["loss"], info.get("nan_frac", 0.0), info.get("skipped_steps", 0),
                info.get("best_restart"), info.get("restart_losses"), timings["policy_s"],
            )
            if log_summaries:
                log_module_summary(loop.policy_model, "policy", logger)

        with tracing.span("episode.rollout") as phase:
            episode = loop.step()
        for key, seconds in {**timings, "rollout_s": phase.seconds}.items():
            totals[key[:-2]] = totals.get(key[:-2], 0.0) + seconds
        scalar_metrics = {k: v for k, v in episode.metrics.items() if np.isscalar(v)}
        logger.info(
            "episode %d metrics: %s timings: %s",
            len(loop.episodes) - 1,
            scalar_metrics,
            {k: f"{v:.1f}s" for k, v in timings.items()},
        )
        if save:
            loop.save()
    logger.info("phase totals: %s", ", ".join(f"{k}={v:.2f}s" for k, v in totals.items()))
    return loop
