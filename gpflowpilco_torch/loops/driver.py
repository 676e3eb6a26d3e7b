"""Task-agnostic outer-loop driver (counterpart of gpflowpilco_tpu/loops/driver.py)."""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from ..utils.summary import PhaseTimer, log_module_summary

logger = logging.getLogger("gpflowpilco_torch.driver")


def outer_loop(
    loop,
    num_episodes: int = 10,
    num_episodes_init: int = 1,
    save: bool = True,
    log_summaries: bool = True,
    trace_dir: Optional[str] = None,
):
    """Alternate (fit dynamics, fit policy, collect episode) until
    ``num_episodes`` episodes exist; the first ``num_episodes_init`` episodes
    act randomly. With ``save``, ``loop.save()`` checkpoints after every
    episode (a no-op for a loop without a directory). Phase wall-clock
    accumulates in a PhaseTimer (set ``trace_dir`` for profiler traces)."""
    timer = PhaseTimer(trace_dir=trace_dir)
    while len(loop.episodes) < num_episodes:
        timings = {}
        if len(loop.episodes) >= num_episodes_init:
            t0 = time.perf_counter()
            with timer.phase("dynamics"):
                info = loop.update_dynamics()
            timings["dynamics_s"] = time.perf_counter() - t0
            logger.info(
                "dynamics: loss=%.4f iters=%d (%.1fs)",
                info["loss"], info["iters"], timings["dynamics_s"],
            )
            if log_summaries:
                log_module_summary(loop.drift_model, "drift", logger)
            t0 = time.perf_counter()
            with timer.phase("policy"):
                info = loop.update_policy()
            timings["policy_s"] = time.perf_counter() - t0
            logger.info(
                "policy: loss=%.5f nan_frac=%.3f skipped=%d best_restart=%s restart_losses=%s (%.1fs)",
                info["loss"], info.get("nan_frac", 0.0), info.get("skipped_steps", 0),
                info.get("best_restart"), info.get("restart_losses"), timings["policy_s"],
            )
            if log_summaries:
                log_module_summary(loop.policy_model, "policy", logger)

        with timer.phase("rollout"):
            episode = loop.step()
        scalar_metrics = {k: v for k, v in episode.metrics.items() if np.isscalar(v)}
        logger.info(
            "episode %d metrics: %s timings: %s",
            len(loop.episodes) - 1,
            scalar_metrics,
            {k: f"{v:.1f}s" for k, v in timings.items()},
        )
        if save:
            loop.save()
    logger.info("phase totals: %s", timer.summary())
    return loop
