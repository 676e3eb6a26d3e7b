"""Command-line plumbing shared by the double-pendulum and mountain-car
runners (examples/*/run_torch.py): their flags, the flags' overrides of the
task's specs, and the run itself."""
from __future__ import annotations

import argparse
import dataclasses
import logging
import random

import torch

from .driver import outer_loop
from .pilco import DriftSpec, PolicySpec


def task_arguments(p: argparse.ArgumentParser, episodes: int, episodes_init: int, variant: str,
                   dt: float, horizon: float, policy_centers: int, drift_centers: int,
                   per_output_noise: bool):
    """Add the runners' flags, with the task's defaults, to ``p``."""
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--episodes", type=int, default=episodes)
    p.add_argument("--episodes-init", type=int, default=episodes_init,
                   help="random-action episodes before the first fit")
    p.add_argument("--device", default="cuda")
    p.add_argument("--variant", choices=["mm", "pathwise"], default=variant)
    p.add_argument("--smoke", action="store_true", help="tiny models and short updates, few episodes")
    p.add_argument("--fused", action="store_true",
                   help="the pathwise drift evaluations through the CUDA path-eval kernel "
                        "(use_fused_paths) and the MM pair grid through the pair-contraction "
                        "kernel (use_fused_mm)")
    p.add_argument("--fused-rollout", action="store_true",
                   help="pathwise: the whole particle rollout loss as one CUDA kernel op "
                        "(use_fused_rollout), where the configuration qualifies")
    p.add_argument("--fused-match", action="store_true",
                   help="mm: the whole-match path (use_fused_match)")
    p.add_argument("--mm-loss-f64", action="store_true",
                   help="mm: the loss in float64 with the policy chain as a float32 island")
    p.add_argument("--f64", action="store_true",
                   help="the whole loop in float64 (models, fits, losses and kernels), the JAX "
                        "runners' default; without it float32")
    p.add_argument("--dt", type=float, default=dt, help="control step, s")
    p.add_argument("--horizon", type=float, default=horizon, help="episode length, s")
    p.add_argument("--policy-centers", type=int, default=policy_centers)
    p.add_argument("--drift-centers", type=int, default=drift_centers)
    p.add_argument("--ls-low", type=float, default=0.01,
                   help="the drift kernel's lengthscale floor; raise it (e.g. 0.1) when a fast "
                        "output drags the fit into a near-interpolating kernel")
    p.add_argument("--step-limit", type=int, default=None,
                   help="Adam steps per policy update (default: the run's)")
    p.add_argument("--restarts", type=int, default=4,
                   help="multistart candidates per policy update (PolicySpec.num_restarts)")
    p.add_argument("--validation-samples", type=int, default=None,
                   help="validation rollouts of the deployed policy per episode (0: none; "
                        "default: the run's)")
    p.add_argument("--per-output-noise", action=argparse.BooleanOptionalAction,
                   default=per_output_noise,
                   help="per-output (P,) likelihood noise on the drift (DriftSpec.per_output_noise)")
    p.add_argument("--drift-optimizer", choices=["lbfgs", "adam", "natgrad_adam"], default="lbfgs",
                   help="the SVGP drift's fit (DriftSpec.optimizer)")
    p.add_argument("--dest", default=None,
                   help="checkpoint directory: restore from it at the start, save every episode")


def loop_dtype(args) -> torch.dtype:
    """The loop's dtype: float64 under --f64, else float32."""
    return torch.float64 if args.f64 else torch.float32


def apply_flags(drift: DriftSpec, policy: PolicySpec, args):
    """The run's specs with the flags' overrides."""
    drift = dataclasses.replace(drift, per_output_noise=args.per_output_noise,
                                optimizer=args.drift_optimizer)
    overrides = {"num_restarts": args.restarts}
    if args.step_limit is not None:
        overrides["step_limit"] = args.step_limit
    if args.mm_loss_f64:
        overrides["loss_dtype"] = torch.float64
    return drift, dataclasses.replace(policy, **overrides)


def setup(args) -> int:
    """Logging and full float32 products; returns the seed (drawn when not
    given)."""
    logging.basicConfig(level=logging.INFO, datefmt="%H:%M:%S",
                        format="%(asctime)s %(levelname)s:%(name)s:%(message)s")
    # full float32 products: the gram cancellations must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = args.seed if args.seed is not None else random.randint(0, 2**31)
    on_card = args.device.startswith("cuda")
    logging.info("seed=%d device=%s", seed, torch.cuda.get_device_name(0) if on_card else args.device)
    return seed


def run(loop, args, episodes: int):
    """Set the kernel routes from the flags and run the outer loop."""
    if loop.episodes:
        logging.info("restored %d episodes from %s", len(loop.episodes), args.dest)
    loop.use_fused_paths = args.fused
    loop.use_fused_mm = args.fused
    loop.use_fused_match = args.fused_match
    loop.use_fused_rollout = args.fused_rollout
    return outer_loop(loop, num_episodes=episodes, num_episodes_init=args.episodes_init,
                      save=args.dest is not None)
