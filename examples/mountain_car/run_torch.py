#!/usr/bin/env python
"""PILCO on mountain car with the PyTorch port, on an NVIDIA GPU.

The torch twin of ``run_mountain_car.py`` and ``experiment.py``: no encoder
(no angular dims), 2-D state (x, dx), a 1-D force in [-4, 4], and a
Gaussian cost around the hilltop goal x = 0.6. The defaults are the full
run: moment matching, 10 Hz control over 5 s (50 steps), drift M=128,
policy M=20, float32 models (``--f64``: the whole loop in float64, the JAX
runner's default). Without an encoder the pathwise variant never
takes the fused rollout kernel; ``--fused`` routes its drift evaluations
through the path-eval kernel and the MM pair grid through the
pair-contraction kernel.

    python examples/mountain_car/run_torch.py --fused --mm-loss-f64
    python examples/mountain_car/run_torch.py --variant pathwise --fused
    python examples/mountain_car/run_torch.py --device cpu --smoke          # tiny CPU run
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from gpflowpilco_torch.components import GaussianObjective  # noqa: E402
from gpflowpilco_torch.envs.mountain_car import MountainCar  # noqa: E402
from gpflowpilco_torch.loops import cli  # noqa: E402
from gpflowpilco_torch.loops.core import EpisodeSpec  # noqa: E402
from gpflowpilco_torch.loops.metrics import holds_for, task_metrics  # noqa: E402
from gpflowpilco_torch.loops.pilco import (  # noqa: E402
    DriftSpec,
    MomentMatchingPILCO,
    PathwisePILCO,
    PILCOBase,
    PolicySpec,
)

GOAL_X = 0.6


def build_task(device, dtype, step_size: float = 0.1, horizon: float = 5.0):
    """Env, objective and episode spec of the hill climb."""
    env = MountainCar()
    target = torch.tensor([GOAL_X, 0.0], dtype=dtype, device=device)
    precis = torch.tensor([[16.0, 0.0], [0.0, 0.25]], dtype=dtype, device=device)
    spec = EpisodeSpec(
        # env.reset draws x ~ U[-0.6, -0.4]; the loop's initial distribution
        # is the Gaussian of that mean and standard deviation
        state_mean=np.asarray([-0.5, 0.0]),
        state_scale_tril=np.diag([0.058, 0.01]),
        horizon=horizon,
        step_size=step_size,
    )
    return env, GaussianObjective.create(target=target, precis=precis), spec


def success_mask(states: torch.Tensor, prox: float = 0.05, num_consecutive: int = 5):
    """Whether the car stays within ``prox`` of the goal for
    ``num_consecutive`` consecutive steps: states (..., T+1, D) -> bool (...)."""
    return holds_for(torch.abs(states[..., 0] - GOAL_X) < prox, num_consecutive)


def _success(loop, states):
    return success_mask(states)


def build_loop(
    seed,
    device,
    dtype,
    drift_spec: DriftSpec = DriftSpec(num_centers=128),
    policy_spec: PolicySpec = PolicySpec(num_centers=20, action_scale=4.0),
    step_size: float = 0.1,
    horizon: float = 5.0,
    loop_cls=MomentMatchingPILCO,
    directory: Optional[str] = None,
    validation_samples: int = 30,
) -> PILCOBase:
    """The mountain-car loop, on the raw 2-D state; with ``directory`` it
    restores from the newest checkpoint there."""
    env, objective, spec = build_task(device, dtype, step_size, horizon)
    loop = loop_cls(
        env=env,
        episode_spec=spec,
        objective=objective,
        encoder=None,
        directory=directory,
        seed=seed,
        device=device,
        dtype=dtype,
        drift_spec=drift_spec,
        policy_spec=policy_spec,
        metrics=task_metrics(_success, validation_samples),
    )
    loop.restore_or_initialize()
    return loop


def run_specs(args):
    """(DriftSpec, PolicySpec, episodes, validation samples) of a run: the
    full run's (``run_mountain_car.py``'s), or ``--smoke``'s, with the flags'
    overrides."""
    if args.smoke:
        drift = DriftSpec(num_centers=24, max_iters=60)
        policy = PolicySpec(num_centers=10, step_limit=200, batch_size=32, num_bases=64,
                            action_scale=4.0)
        episodes, validation = min(args.episodes, 2), 4
    else:
        drift = DriftSpec(num_centers=args.drift_centers, max_iters=600, ls_low=args.ls_low)
        policy = PolicySpec(num_centers=args.policy_centers, step_limit=3000, action_scale=4.0)
        episodes, validation = args.episodes, 30
    if args.validation_samples is not None:
        validation = args.validation_samples
    return (*cli.apply_flags(drift, policy, args), episodes, validation)


def parser() -> argparse.ArgumentParser:
    """The runner's flags, with the full run's defaults."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.task_arguments(p, episodes=8, episodes_init=1, variant="mm", dt=0.1, horizon=5.0,
                       policy_centers=20, drift_centers=128, per_output_noise=False)
    return p


def loop_from_args(args, seed):
    """(loop, episodes) of a run: the specs from the flags, the loop in the
    flags' dtype (float32, or float64 under --f64)."""
    drift, policy, episodes, validation = run_specs(args)
    loop = build_loop(
        seed, torch.device(args.device), cli.loop_dtype(args),
        drift_spec=drift, policy_spec=policy, step_size=args.dt, horizon=args.horizon,
        loop_cls=MomentMatchingPILCO if args.variant == "mm" else PathwisePILCO,
        directory=args.dest, validation_samples=validation,
    )
    return loop, episodes


def main():
    args = parser().parse_args()
    loop, episodes = loop_from_args(args, cli.setup(args))
    cli.run(loop, args, episodes)


if __name__ == "__main__":
    main()
