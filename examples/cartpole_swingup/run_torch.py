#!/usr/bin/env python
"""PILCO on cartpole swing-up with the PyTorch port, on an NVIDIA GPU.

The torch twin of ``run_tpu_full.py``: SVGP drift (<= --num-centers inducing
points) fit by L-BFGS, 30-step horizon, float32 models and fits.
``--variant pathwise`` (the default) optimizes 1024 particles x 1024 Fourier
bases per policy step through the CUDA path-eval kernel; ``--variant mm``
propagates Gaussian moments, with ``--fused`` routing the eKuffu pair grid
through the CUDA pair-contraction kernel and ``--mm-loss-f64`` (or
``--mm-loss-dd``) running the MM loss in float64. Validation rollouts,
multistart and checkpoints are not ported yet.

    python examples/cartpole_swingup/run_torch.py --episodes 10
    python examples/cartpole_swingup/run_torch.py --variant mm --fused --mm-loss-f64
    python examples/cartpole_swingup/run_torch.py --device cpu --episodes 3 \\
        --step-limit 20 --batch-size 16 --num-bases 32 --num-centers 16   # tiny CPU run
    python examples/cartpole_swingup/run_torch.py --device cpu --variant mm --fused \\
        --mm-loss-f64 --episodes 3 --step-limit 5 --num-centers 16 --lbfgs-iters 30
"""
from __future__ import annotations

import argparse
import logging
import math
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from gpflowpilco_torch.components import GaussianObjective, trigonometric_encoder  # noqa: E402
from gpflowpilco_torch.envs.cartpole import CartPole  # noqa: E402
from gpflowpilco_torch.loops.core import EpisodeSpec  # noqa: E402
from gpflowpilco_torch.loops.driver import outer_loop  # noqa: E402
from gpflowpilco_torch.loops.metrics import metric_expected_reward, metric_rewards  # noqa: E402
from gpflowpilco_torch.loops.pilco import (  # noqa: E402
    DriftSpec,
    MomentMatchingPILCO,
    PathwisePILCO,
    PILCOBase,
    PolicySpec,
)


def build_task(device, dtype, step_size: float = 0.1, horizon: float = 3.0):
    """Env, encoder, objective and episode spec of the swing-up task."""
    env = CartPole()
    encoder = trigonometric_encoder(active_dims=(1,))
    target = encoder(torch.zeros(4, dtype=dtype, device=device))  # upright
    h = env.pole_height
    precis = 16.0 * torch.tensor(
        [
            [h * h, 0, -h, 0, 0],
            [0, h * h, 0, 0, 0],
            [-h, 0, 1, 0, 0],
            [0, 0, 0, 0, 0],
            [0, 0, 0, 0, 0],
        ],
        dtype=dtype,
        device=device,
    )
    spec = EpisodeSpec(
        state_mean=np.asarray([0.0, math.pi, 0.0, 0.0]),
        state_scale_tril=0.1 * np.eye(4),
        horizon=horizon,
        step_size=step_size,
    )
    return env, encoder, GaussianObjective.create(target=target, precis=precis), spec


def build_loop(seed, device, dtype, drift_spec=DriftSpec(), policy_spec=PolicySpec(),
               step_size: float = 0.1, horizon: float = 3.0,
               loop_cls=PathwisePILCO) -> PILCOBase:
    env, encoder, objective, spec = build_task(device, dtype, step_size, horizon)
    return loop_cls(
        env=env,
        episode_spec=spec,
        objective=objective,
        encoder=encoder,
        seed=seed,
        device=device,
        dtype=dtype,
        drift_spec=drift_spec,
        policy_spec=policy_spec,
        metrics={"rewards": metric_rewards, "eReward": metric_expected_reward},
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--episodes-init", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--variant", choices=["pathwise", "mm"], default="pathwise")
    p.add_argument("--fused", action="store_true",
                   help="mm: route the eKuffu pair grid through the CUDA pair-contraction "
                        "kernel (use_fused_mm); the pathwise variant always uses its kernel")
    p.add_argument("--mm-loss-f64", action="store_true",
                   help="mm: float64 loss with the policy chain as a float32 island "
                        "(PolicySpec.loss_dtype, loss_policy_f32)")
    p.add_argument("--mm-loss-dd", action="store_true",
                   help="mm: the JAX package's compensated loss, here float64 with a "
                        "float64 policy chain (PolicySpec.loss_compensated)")
    p.add_argument("--step-limit", type=int, default=5000)
    p.add_argument("--num-centers", type=int, default=240)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-bases", type=int, default=1024)
    p.add_argument("--lbfgs-iters", type=int, default=1000)
    args = p.parse_args()

    logging.basicConfig(
        level=logging.INFO,
        datefmt="%H:%M:%S",
        format="%(asctime)s %(levelname)s:%(name)s:%(message)s",
    )
    # full float32 products: the gram cancellations must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device.startswith("cuda"):
        logging.info("device: %s", torch.cuda.get_device_name(0))
    loop = build_loop(
        args.seed,
        torch.device(args.device),
        torch.float32,
        drift_spec=DriftSpec(num_centers=args.num_centers, max_iters=args.lbfgs_iters),
        policy_spec=PolicySpec(
            step_limit=args.step_limit,
            batch_size=args.batch_size,
            num_bases=args.num_bases,
            num_restarts=1,
            loss_dtype=torch.float64 if args.mm_loss_f64 and not args.mm_loss_dd else None,
            loss_compensated=args.mm_loss_dd,
            loss_policy_f32=not args.mm_loss_dd,
        ),
        loop_cls=MomentMatchingPILCO if args.variant == "mm" else PathwisePILCO,
    )
    loop.use_fused_mm = args.fused
    outer_loop(loop, num_episodes=args.episodes, num_episodes_init=args.episodes_init)


if __name__ == "__main__":
    main()
