#!/usr/bin/env python3
"""Time K3 (the whole SVGP match, csrc/mm_match.cu) on one NVIDIA GPU: this
checkout against another (a parent commit's ``git archive``), in one run on
one card.

    python scripts/k3_bench.py [--parent DIR] [--out FILE]

Both checkouts build first, their ``nvcc`` processes together. Then each
runs in a process of its own, in turns (parent, this, this, parent), and
times every K3 entry at the whole-match path's shapes with chip_smoke.py's
method (median device time over 30 calls, L2 flushed;
chip_smoke.match_bound_ms for the bound). Each checkout is reported by the
smaller of its two medians. The parent's and this checkout's full backward
are compared bit for bit on the same inputs, and each checkout's per-stage
device times (torch.profiler) are printed. The last line is one JSON object
of all the numbers, also written to --out.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (entry, dtype, shape): the entries as the whole-match path runs them (the
# drift's forward and frozen backward, the policy's forward and full
# backward, all float32) and the float64 entries at the drift's shape
CASES = (
    ("fwd", "f32", "drift"), ("fwd", "f32", "policy"), ("bwd_frozen", "f32", "drift"),
    ("bwd", "f32", "policy"), ("fwd", "f64", "drift"), ("bwd_frozen", "f64", "drift"),
    ("bwd", "f64", "drift"),
)


def _smoke():
    """This checkout's chip_smoke.py, by path: a parent checkout has one too."""
    spec = importlib.util.spec_from_file_location("k3_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(root):
    sys.path.insert(0, str(root))
    from gpflowpilco_torch.ops import _build

    took = _build.build_all(["mm_match"])
    ptxas = _smoke().ptxas_report(getattr(_build, "compiler_output", {}).get("mm_match", ""))
    print(json.dumps({"built": str(root), "seconds": took.get("mm_match"), "ptxas": ptxas}))


def run(root, save):
    import torch

    sys.path.insert(0, str(root))
    from gpflowpilco_torch.ops import mm_match_cuda as mc

    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    res, outs = {}, {}
    for kind, sfx, where in CASES:
        n, num_l, d, m, unc = cs.MATCH_SHAPES[where]
        dtype = dtypes[sfx]
        g = cs.match_grid(num_l, d, m, unc, dtype, device, 7 + m)
        rng = cs.np.random.default_rng(11)
        mx, sxx = cs.state_moments(rng, n, d, dtype, device)
        f = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype, device=device)  # noqa: E731
        cots = (f(n, num_l), f(n, num_l, num_l), f(n, d, num_l))
        f1 = mc.match_reference(g.meta, g, mx, sxx)[0]  # the same in both checkouts
        if kind == "fwd":
            fn = lambda: mc._fwd(g.meta, g, mx, sxx)  # noqa: E731
        else:
            fn = lambda: mc._bwd(g.meta, g, mx, sxx, f1, *cots, kind == "bwd_frozen")  # noqa: E731
        out = fn()
        outs[f"{kind}_{sfx}_{where}"] = [t.cpu() for t in (
            out if kind == "fwd" else (*out[:2], *(out[2].tensors() if out[2] is not None else ())))]
        ms = cs.median_ms(fn, flush=flush)
        stages = cs.stage_ms(fn)
        bound, _ = cs.match_bound_ms(kind, g.meta, n, dtype)
        res[f"{kind}_{sfx}_{where}"] = dict(ms=ms, bound_ms=bound, stages=stages)
    torch.save(outs, save)
    print(json.dumps(res))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--parent", default=None, help="a checkout to time beside this one")
    p.add_argument("--out", default=str(ROOT / "build" / "k3_bench" / "k3_bench.json"))
    p.add_argument("--build", metavar="ROOT", help=argparse.SUPPRESS)
    p.add_argument("--run", nargs=2, metavar=("ROOT", "SAVE"), help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.build:
        return build(Path(args.build))
    if args.run:
        return run(Path(args.run[0]), args.run[1])

    import torch

    if not torch.cuda.is_available():
        sys.exit("k3_bench: no CUDA device; this runs only on an NVIDIA GPU")
    card = _smoke().card_line()
    print(f"card: {card}")
    roots = {"this": ROOT}
    if args.parent:
        roots["parent"] = Path(args.parent).resolve()
    me = [sys.executable, str(Path(__file__).resolve())]
    procs = [subprocess.Popen([*me, "--build", str(r)], stdout=subprocess.PIPE, text=True)
             for r in roots.values()]
    for proc in procs:
        lines = proc.communicate()[0].strip().splitlines()
        print(f"build: {lines[-1] if lines else ''}")
        if proc.returncode:
            sys.exit("k3_bench: a build failed")
    order = ["parent", "this", "this", "parent"] if args.parent else ["this", "this"]
    out_dir = Path(args.out).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {}
    for i, name in enumerate(order):
        save = out_dir / f"k3_bench_outputs_{name}.pt"
        proc = subprocess.run([*me, "--run", str(roots[name]), str(save)], stdout=subprocess.PIPE,
                              text=True, check=True)
        runs.setdefault(name, []).append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"run {i + 1}/{len(order)} {name}: " + ", ".join(
            f"{k} {v['ms']:.4f}" for k, v in runs[name][-1].items()))
    table = {}
    for name, rs in runs.items():
        table[name] = {
            k: dict(ms=min(r[k]["ms"] for r in rs), all_ms=[r[k]["ms"] for r in rs],
                    bound_ms=rs[0][k]["bound_ms"], stages=rs[0][k]["stages"])
            for k in rs[0]
        }
    print(f"{'entry':28s}" + "".join(f"{n:>14s}" for n in table))
    for k in table["this"]:
        print(f"{k:28s}" + "".join(f"{table[n][k]['ms']:14.4f}" for n in table))
    for name, rows in table.items():
        for k, row in rows.items():
            print(f"stages {name} {k}: " + ", ".join(f"{s} {v:.4f} ms" for s, v in row["stages"].items()))
    result = {"card": card, "ms": table}
    if args.parent:
        a = torch.load(out_dir / "k3_bench_outputs_this.pt")
        b = torch.load(out_dir / "k3_bench_outputs_parent.pt")
        same = {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a if k.startswith("bwd_")
                and not k.startswith("bwd_frozen")}
        print(f"full backward bit-identical to the parent's: {same}")
        result["full_bwd_bit_identical"] = same
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
