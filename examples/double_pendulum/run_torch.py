#!/usr/bin/env python
"""PILCO on the double-pendulum swing-up with the PyTorch port, on an NVIDIA GPU.

The torch twin of ``run_double_pendulum.py`` and ``experiment.py``: both
links start hanging (absolute angles a0 = a1 = pi from upright) and must be
swung up and balanced by a 2-D torque in [-2, 2]. Two angular dims go
through the trig encoder (6 features); the drift is an SVGP with
linear coregionalization (4 outputs mixed from 4 latent GPs by a trained W,
per-output noise), the policy a coregionalized SVGP (2 torques from 2
latents through a frozen W) squashed to the torque box. The cost is a
Gaussian in the distance from the outer tip to the upright goal (0, l0 + l1),
exactly in the features:

  d^2 = err^T Q err,  err = [sin a0, sin a1, cos a0 - 1, cos a1 - 1]
  Q   = [[l0^2, l0 l1], [l0 l1, l1^2]] (x) I_2   (sin block, cos block)

The defaults are the full run: 20 Hz control over 2.5 s (50 steps), drift
M=320, policy M=100, 1024 particles x 1024 bases, float32 models, pathwise
(``--f64``: the whole loop in float64, the JAX runner's default).
``--fused`` routes the pathwise drift evaluations through the CUDA path-eval
kernel and the MM pair grid through the pair-contraction kernel,
``--fused-rollout`` the whole pathwise rollout loss through one kernel op,
``--fused-match`` the whole MM match; ``--mm-loss-f64`` runs the MM loss in
float64 with a float32 policy island.

    python examples/double_pendulum/run_torch.py --fused-rollout --episodes 15
    python examples/double_pendulum/run_torch.py --fused-rollout --episodes 3 --step-limit 200
    python examples/double_pendulum/run_torch.py --variant mm --fused --mm-loss-f64
    python examples/double_pendulum/run_torch.py --device cpu --smoke          # tiny CPU run
    python examples/double_pendulum/run_torch.py --device cpu --smoke --variant mm --fused-match
"""
from __future__ import annotations

import argparse
import math
import pathlib
import sys
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from gpflowpilco_torch.components import GaussianObjective, trigonometric_encoder  # noqa: E402
from gpflowpilco_torch.envs.double_pendulum import DoublePendulum  # noqa: E402
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

HOLD_SECONDS = 1.0  # the balance hold that counts as success, in seconds of sim time


def build_task(device, dtype, step_size: float = 0.1, horizon: float = 4.0):
    """Env, encoder, objective and episode spec of the swing-up task."""
    env = DoublePendulum()
    encoder = trigonometric_encoder(active_dims=(0, 1))
    # feature layout: [sin a0, sin a1, cos a0, cos a1, da0, da1]
    target = encoder(torch.zeros(4, dtype=dtype, device=device))  # upright: [0, 0, 1, 1, 0, 0]
    l0, l1 = env.length0, env.length1
    q = np.asarray([[l0 * l0, l0 * l1], [l0 * l1, l1 * l1]])
    precis = np.zeros((6, 6))
    precis[:2, :2] = q  # sin block
    precis[2:4, 2:4] = q  # cos block
    # cost length-scale 0.5 m over a reach of l0 + l1 = 1 m
    precis = torch.as_tensor(4.0 * precis, dtype=dtype, device=device)
    spec = EpisodeSpec(
        # as env.reset: hanging, nearly at rest
        state_mean=np.asarray([math.pi, math.pi, 0.0, 0.0]),
        state_scale_tril=np.diag([0.01, 0.01, 0.1, 0.1]),
        horizon=horizon,
        step_size=step_size,
    )
    return env, encoder, GaussianObjective.create(target=target, precis=precis), spec


def success_mask(env, states: torch.Tensor, step_size: float, prox_threshold: float = 0.2):
    """Whether the outer tip stays within ``prox_threshold`` x the reach of
    the upright goal for ``HOLD_SECONDS`` of consecutive sim time: states
    (..., T+1, D) -> bool (...)."""
    reach = env.length0 + env.length1
    _, (x1, y1) = env.get_vertex_coordinates(states)
    near = torch.sqrt(x1**2 + (y1 - reach) ** 2) < prox_threshold * reach
    return holds_for(near, max(1, round(HOLD_SECONDS / step_size)))


def _success(loop, states):
    return success_mask(loop.env, states, loop.episode_spec.step_size)


def build_loop(
    seed,
    device,
    dtype,
    # LCK drift: 4 outputs mixed from 4 latent GPs (W starts at the identity
    # and trains); per-output noise, since the angle deltas are ~0.3 against
    # velocity deltas of ~5 at dt = 0.05
    drift_spec: DriftSpec = DriftSpec(coregionalize=True, per_output_noise=True),
    # 2 torques from 2 latents through a frozen identity W, squashed to [-2, 2]
    policy_spec: PolicySpec = PolicySpec(num_centers=40, action_scale=2.0, coregionalize=True),
    step_size: float = 0.1,
    horizon: float = 4.0,
    loop_cls=PathwisePILCO,
    directory: Optional[str] = None,
    validation_samples: int = 100,
) -> PILCOBase:
    """The swing-up loop; with ``directory`` it restores from the newest
    checkpoint there."""
    env, encoder, objective, spec = build_task(device, dtype, step_size, horizon)
    loop = loop_cls(
        env=env,
        episode_spec=spec,
        objective=objective,
        encoder=encoder,
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
    full run's (``run_double_pendulum.py``'s), or ``--smoke``'s, with the
    flags' overrides."""
    if args.smoke:
        drift = DriftSpec(num_centers=32, max_iters=60, coregionalize=True)
        policy = PolicySpec(num_centers=10, step_limit=200, batch_size=32, num_bases=64,
                            action_scale=2.0, coregionalize=True)
        episodes, validation = min(args.episodes, 3), 4
    else:
        # per-output noise needs a longer L-BFGS budget: the disparate output
        # scales slow the joint hyperparameter convergence
        drift = DriftSpec(num_centers=args.drift_centers, max_iters=1600, coregionalize=True,
                          ls_low=args.ls_low)
        policy = PolicySpec(num_centers=args.policy_centers, step_limit=3000, action_scale=2.0,
                            coregionalize=True)
        episodes, validation = args.episodes, 100
    if args.validation_samples is not None:
        validation = args.validation_samples
    return (*cli.apply_flags(drift, policy, args), episodes, validation)


def parser() -> argparse.ArgumentParser:
    """The runner's flags, with the full run's defaults."""
    # classic-PILCO double-pendulum settings: 20 Hz control over 2.5 s, ~100
    # policy basis functions
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.task_arguments(p, episodes=15, episodes_init=2, variant="pathwise", dt=0.05, horizon=2.5,
                       policy_centers=100, drift_centers=320, per_output_noise=True)
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
