#!/usr/bin/env python
"""PILCO on cartpole swing-up with the PyTorch port, on an NVIDIA GPU.

The torch twin of ``run_tpu_full.py``: SVGP drift (<= --num-centers inducing
points) fit by L-BFGS, 30-step horizon, float32 models and fits (``--f64``: the
whole loop, its kernels included, in float64, the JAX runners' default).
``--variant pathwise`` (the default) optimizes 1024 particles x 1024 Fourier
bases per policy step, with ``--fused`` through the CUDA path-eval kernel
(plain torch without it, as the JAX package's default); ``--variant mm``
propagates Gaussian moments, with ``--fused`` routing the eKuffu pair grid
through the CUDA pair-contraction kernel, ``--fused-match`` running the
whole-match path (the whole SVGP match, encoder match, PSD guard and Euler
update as CUDA kernels; the twin of ``run_tpu_full.py --fused-match``), and
``--mm-loss-f64`` (or ``--mm-loss-dd``) running the MM loss in float64.
``--drift-optimizer hmc`` (the twin of ``run_tpu_full.py --drift-optimizer
hmc``) fits an exact GPR drift by L-BFGS, samples its hyperparameters by HMC
and trains the policy through the posterior-averaged loss over an ensemble
of --hmc-ensemble draws; both variants and every MM option take it.
``--variant pathwise --fused-rollout`` runs the whole 30-step particle
rollout loss as one CUDA kernel op per Adam step, forward and backward (the
twin of ``run_tpu_full.py --fused-rollout``), under an SVGP drift or the HMC
ensemble. Each policy update runs --restarts candidates (best-seen, lowest
loss wins); each episode is validated by --validation-samples rollouts of
the deployed policy (vReward, vSuccess); ``--per-output-noise``,
``--optimism-tol`` and ``--optimism-noise-mult`` set the drift's noise
options as in ``run_tpu_full.py``; with ``--dest`` the run restores from the
newest checkpoint there and checkpoints every episode.

    python examples/cartpole_swingup/run_torch.py --fused --episodes 10
    python examples/cartpole_swingup/run_torch.py --fused-rollout --seed 3 --episodes 10 \
        --restarts 4 --step-limit 5000 --validation-samples 100 --dest DIR
    python examples/cartpole_swingup/run_torch.py --variant mm --fused --mm-loss-f64
    python examples/cartpole_swingup/run_torch.py --variant mm --fused-match
    python examples/cartpole_swingup/run_torch.py --device cpu --episodes 3 \\
        --step-limit 20 --batch-size 16 --num-bases 32 --num-centers 16   # tiny CPU run
    python examples/cartpole_swingup/run_torch.py --device cpu --variant mm --fused \\
        --mm-loss-f64 --episodes 3 --step-limit 5 --num-centers 16 --lbfgs-iters 30
    python examples/cartpole_swingup/run_torch.py --device cpu --variant mm --fused-match \\
        --episodes 3 --step-limit 5 --num-centers 16 --lbfgs-iters 30
    python examples/cartpole_swingup/run_torch.py --device cpu --fused-rollout --episodes 2 \\
        --step-limit 5 --batch-size 16 --num-bases 32 --num-centers 16 --lbfgs-iters 30
    python examples/cartpole_swingup/run_torch.py --device cpu --variant mm --fused-match \\
        --drift-optimizer hmc --episodes 2 --step-limit 3 --lbfgs-iters 20 \\
        --hmc-warmup 10 --hmc-samples 10 --hmc-leapfrog 4 --hmc-chains 2 --hmc-ensemble 3
"""
from __future__ import annotations

import argparse
import logging
import math
import pathlib
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parents[1]), str(HERE)]

from gpflowpilco_torch.components import GaussianObjective, trigonometric_encoder  # noqa: E402
from gpflowpilco_torch.envs.cartpole import CartPole  # noqa: E402
from gpflowpilco_torch.loops.cli import loop_dtype  # noqa: E402
from gpflowpilco_torch.loops.core import EpisodeSpec  # noqa: E402
from gpflowpilco_torch.loops.driver import outer_loop  # noqa: E402
from gpflowpilco_torch.loops.pilco import (  # noqa: E402
    DriftSpec,
    MomentMatchingPILCO,
    PathwisePILCO,
    PILCOBase,
    PolicySpec,
)
from metrics_torch import episode_metrics  # noqa: E402


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
               loop_cls=PathwisePILCO, directory=None, validation_samples: int = 0) -> PILCOBase:
    """The swing-up loop; with ``directory`` it restores from the newest
    checkpoint there, and ``validation_samples`` > 0 adds validation."""
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
        metrics=episode_metrics(validation_samples),
    )
    loop.restore_or_initialize()
    return loop


def parser() -> argparse.ArgumentParser:
    """The runner's flags."""
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--episodes-init", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--variant", choices=["pathwise", "mm"], default="pathwise")
    p.add_argument("--fused", action="store_true",
                   help="the fused kernel ops, as run_tpu_full.py --fused: the pathwise SVGP "
                        "drift evaluations through the CUDA path-eval kernel (use_fused_paths) "
                        "and the MM eKuffu pair grid through the CUDA pair-contraction kernel "
                        "(use_fused_mm)")
    p.add_argument("--fused-match", action="store_true",
                   help="mm: the whole-match path (use_fused_match): whole SVGP match, encoder "
                        "match, PSD guard and Euler update as CUDA kernels; its drift, encoder "
                        "and glue kernels run when the loss is in the loop dtype")
    p.add_argument("--fused-rollout", action="store_true",
                   help="pathwise: the whole particle rollout loss as one CUDA kernel op, "
                        "forward and backward (use_fused_rollout), where the configuration "
                        "qualifies; supersedes the path-eval kernel")
    p.add_argument("--mm-loss-f64", action="store_true",
                   help="mm: float64 loss with the policy chain as a float32 island "
                        "(PolicySpec.loss_dtype, loss_policy_f32)")
    p.add_argument("--mm-loss-dd", action="store_true",
                   help="mm: the JAX package's compensated loss, here float64 with a "
                        "float64 policy chain (PolicySpec.loss_compensated)")
    p.add_argument("--drift-optimizer", choices=["lbfgs", "hmc"], default="lbfgs",
                   help="hmc: an exact GPR drift whose hyperparameters are sampled by HMC, "
                        "thinned to an ensemble (DriftSpec model_type='gpr', optimizer='hmc')")
    p.add_argument("--hmc-chains", type=int, default=8)
    p.add_argument("--hmc-warmup", type=int, default=200)
    p.add_argument("--hmc-samples", type=int, default=200)
    p.add_argument("--hmc-leapfrog", type=int, default=16)
    p.add_argument("--hmc-ensemble", type=int, default=8)
    p.add_argument("--step-limit", type=int, default=5000)
    p.add_argument("--num-centers", type=int, default=240)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-bases", type=int, default=1024)
    p.add_argument("--lbfgs-iters", type=int, default=1000)
    p.add_argument("--restarts", type=int, default=4,
                   help="multistart candidates per policy update (PolicySpec.num_restarts)")
    p.add_argument("--validation-samples", type=int, default=100,
                   help="validation rollouts of the deployed policy per episode (0: none)")
    p.add_argument("--per-output-noise", action="store_true",
                   help="per-output (P,) likelihood noise on the drift SVGP "
                        "(DriftSpec.per_output_noise)")
    p.add_argument("--optimism-tol", type=float, default=0.0,
                   help="the pessimistic refit: when the last episode's eReward exceeded its "
                        "realized reward by more than this, floor the refit noise at the "
                        "incumbent's held-out episode MSE (DriftSpec.optimism_tolerance; 0 disables)")
    p.add_argument("--optimism-noise-mult", type=float, default=1.0,
                   help="scale on the held-out-MSE noise floor (DriftSpec.optimism_noise_mult)")
    p.add_argument("--f64", action="store_true",
                   help="the whole loop in float64 (models, fits, losses and kernels), the JAX "
                        "runners' default; without it float32")
    p.add_argument("--dest", default=None,
                   help="checkpoint directory: restore from it at the start, save every episode")
    return p


def loop_from_args(args):
    """The run's loop, in the flags' dtype (float32, or float64 under
    --f64)."""
    return build_loop(
        args.seed,
        torch.device(args.device),
        loop_dtype(args),
        drift_spec=DriftSpec(
            num_centers=args.num_centers,
            max_iters=args.lbfgs_iters,
            model_type="gpr" if args.drift_optimizer == "hmc" else "svgp",
            optimizer=args.drift_optimizer,
            hmc_chains=args.hmc_chains,
            hmc_warmup=args.hmc_warmup,
            hmc_samples=args.hmc_samples,
            hmc_leapfrog=args.hmc_leapfrog,
            hmc_ensemble=args.hmc_ensemble,
            per_output_noise=args.per_output_noise,
            optimism_tolerance=args.optimism_tol,
            optimism_noise_mult=args.optimism_noise_mult,
        ),
        policy_spec=PolicySpec(
            step_limit=args.step_limit,
            batch_size=args.batch_size,
            num_bases=args.num_bases,
            num_restarts=args.restarts,
            loss_dtype=torch.float64 if args.mm_loss_f64 and not args.mm_loss_dd else None,
            loss_compensated=args.mm_loss_dd,
            loss_policy_f32=not args.mm_loss_dd,
        ),
        loop_cls=MomentMatchingPILCO if args.variant == "mm" else PathwisePILCO,
        directory=args.dest,
        validation_samples=args.validation_samples,
    )


def main():
    args = parser().parse_args()

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
    loop = loop_from_args(args)
    if loop.episodes:
        logging.info("restored %d episodes from %s", len(loop.episodes), args.dest)
    loop.use_fused_paths = args.fused
    loop.use_fused_mm = args.fused
    loop.use_fused_match = args.fused_match
    loop.use_fused_rollout = args.fused_rollout
    outer_loop(loop, num_episodes=args.episodes, num_episodes_init=args.episodes_init,
               save=args.dest is not None)


if __name__ == "__main__":
    main()
