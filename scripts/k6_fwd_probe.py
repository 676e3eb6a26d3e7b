#!/usr/bin/env python3
"""Sweep K6's forward (csrc/rollout.cu's fwd_warp) over its shape on one
NVIDIA GPU, to see which part of the work sets its time: the slice's shape
(S=1024, B=1024, M=240, Mp=30, Ld=4, T=30) and, one at a time, fewer bases,
centers, steps, latents or particles, and the other staging route.

    python scripts/k6_fwd_probe.py [--dtype f32|f64] [--out FILE]

Each shape is timed by chip_smoke.py's median_ms (median device time over
30 calls after a warm-up, L2 flushed) on chip_smoke's rollout operands. It
prints the card, each shape's route, shared memory and ms, and the ptxas
report (registers, stack, spills) of every fwd_warp instantiation when this
process built the library. The last line is one JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dtype", default="f32", choices=("f32", "f64"))
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("k6_fwd_probe: no CUDA device; this runs only on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("k6_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from gpflowpilco_torch.ops import _build
    from gpflowpilco_torch.ops import rollout_cuda as rc

    card = cs.card_line()
    print(f"card: {card}")
    _build.build_all(["rollout"])
    report = _build.compiler_output.get("rollout", "")
    keep, lines = False, []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            keep = "fwd_warp" in line
        if keep and ("Compiling entry" in line or "stack frame" in line or "Used" in line):
            lines.append(line.strip())
    print("\n".join(lines))

    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    device = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)
    # (label, members, particles, Ld, B, M, steps, route)
    shapes = [
        ("slice", 1, cs.S, cs.L, cs.B, cs.M, cs.HORIZON_STEPS, None),
        ("B=512", 1, cs.S, cs.L, 512, cs.M, cs.HORIZON_STEPS, None),
        ("B=256", 1, cs.S, cs.L, 256, cs.M, cs.HORIZON_STEPS, None),
        ("M=16", 1, cs.S, cs.L, cs.B, 16, cs.HORIZON_STEPS, None),
        ("T=15", 1, cs.S, cs.L, cs.B, cs.M, 15, None),
        ("T=1", 1, cs.S, cs.L, cs.B, cs.M, 1, None),
        ("Ld=1", 1, cs.S, 1, cs.B, cs.M, cs.HORIZON_STEPS, None),
        ("S=512", 1, 512, cs.L, cs.B, cs.M, cs.HORIZON_STEPS, None),
        ("S=128", 1, 128, cs.L, cs.B, cs.M, cs.HORIZON_STEPS, None),
        ("ring", 1, cs.S, cs.L, cs.B, cs.M, cs.HORIZON_STEPS, "ring"),
    ]
    res = {}
    for label, k, s, ld, b, m, steps, route in shapes:
        meta, ops = cs.rollout_operands(rc, k, s, 1, ld, 1, steps, dtype, device, 4000, b=b, m=m)
        plan = rc.fwd_plan(meta, b, m, dtype)
        if route is not None and route != plan[0]:
            plan = (route, None)
        ms = cs.median_ms(lambda: rc._fwd(meta, *ops, route=route), flush=flush)
        res[label] = dict(ms=ms, route=plan[0], smem=plan[1], S=s, Ld=ld, B=b, M=m, T=steps)
        print(f"{label:8s} S={s} Ld={ld} B={b} M={m} T={steps} {plan[0]}: {ms:.4f} ms")
    out = {"card": card, "dtype": args.dtype, "ms": res, "ptxas": lines}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
