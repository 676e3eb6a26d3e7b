#!/usr/bin/env python3
"""Host cost of the multistart driver's best-seen tracking on the card.

Builds the fused-rollout loop of ``chip_smoke.py`` (cartpole, 8 random
episodes, an SVGP drift with M=240 fit by L-BFGS, 1024 particles x 1024
bases, 30 steps) and times, in turns on one card, ``--steps`` Adam steps of
the K6 loss through ``adam_minimize`` (single start) and through
``adam_minimize_multistart`` with one candidate (the same steps plus the
best-seen ``torch.where``s), ``--pairs`` times each. Prints the ms per step
of every run and the card's name and power limit.

    python3 scripts/multistart_overhead.py [--steps 100] [--pairs 4]
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "examples" / "cartpole_swingup")]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("multistart_overhead: needs an NVIDIA GPU")
    from run_torch import build_loop

    from gpflowpilco_torch.loops.driver import outer_loop
    from gpflowpilco_torch.loops.pilco import DriftSpec, PolicySpec
    from gpflowpilco_torch.models.builders import policy_mask
    from gpflowpilco_torch.utils.optimizers import (
        adam_minimize,
        adam_minimize_multistart,
        make_policy_schedule,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    loop = build_loop(args.seed, device, torch.float32, drift_spec=DriftSpec(num_centers=240, max_iters=100),
                      policy_spec=PolicySpec(num_restarts=1))
    outer_loop(loop, num_episodes=8, num_episodes_init=8, log_summaries=False)
    loop.update_dynamics()
    loop.policy_model = loop.build_policy()
    loop.use_fused_rollout = True
    drift = loop.policy_loss_drift()
    schedule = make_policy_schedule(args.steps, 0.01)

    def run(kind):
        model = copy.deepcopy(loop.policy_model)
        gen = loop.iteration_generator(2)
        loss = lambda: loop.policy_loss_fn(model, gen, drift=drift)  # noqa: E731
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "single":
            adam_minimize(loss, policy_mask(model), args.steps, schedule=schedule)
        else:
            adam_minimize_multistart([loss], [policy_mask(model)], args.steps, schedule=schedule)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / args.steps

    run("single")  # warm-up: the kernels' build and first launches
    times = {"single": [], "multistart": []}
    for i in range(args.pairs):
        order = ("single", "multistart") if i % 2 == 0 else ("multistart", "single")
        for kind in order:
            times[kind].append(run(kind))
    print(f"card: {card}")
    print(json.dumps({"ms_per_step": times, "steps": args.steps}))


if __name__ == "__main__":
    main()
