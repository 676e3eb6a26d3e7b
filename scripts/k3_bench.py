#!/usr/bin/env python3
"""Time K3 (the whole SVGP match, csrc/mm_match.cu) and K3g (the whole GPR
match, csrc/gpr_match.cu) on one NVIDIA GPU: this checkout against another
(a parent commit's ``git archive``), in one run on one card.

    python scripts/k3_bench.py [--parent DIR] [--out FILE]

Both checkouts build first, their ``nvcc`` processes together. Then each
runs in a process of its own, in turns (parent, this, this, parent), and
times every K3 entry at the whole-match path's shapes and K3g's at the HMC
ensemble's with chip_smoke.py's method (median device time over 30 calls,
L2 flushed; chip_smoke.match_bound_ms and gpr_match_bound_ms for the
bounds). Each checkout is reported by the smaller of its two medians. The
parent's and this checkout's K3 full backward and K3g forward are compared
bit for bit on the same inputs, and each checkout's per-stage device times
(torch.profiler) are printed. The last line is one JSON object of all the
numbers, also written to --out.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (entry, dtype, shape): K3's entries as the whole-match path runs them (the
# drift's forward and frozen backward, the policy's forward and full
# backward, all float32), the full backward with the HMC ensemble's 8
# members as its batch, and the float64 entries at the drift's shape; K3g's
# forward and frozen backward at the ensemble's shape (K=8, N=240, D=6, R=4)
CASES = (
    ("fwd", "f32", "drift"), ("fwd", "f32", "policy"), ("bwd_frozen", "f32", "drift"),
    ("bwd", "f32", "policy"), ("bwd", "f32", "ensemble policy"), ("fwd", "f64", "drift"),
    ("bwd_frozen", "f64", "drift"), ("bwd", "f64", "drift"),
    ("gpr_fwd", "f32", "ensemble"), ("gpr_bwd_frozen", "f32", "ensemble"),
    ("gpr_fwd", "f64", "ensemble"), ("gpr_bwd_frozen", "f64", "ensemble"),
)
LIBS = ("mm_match", "gpr_match")


def _smoke():
    """This checkout's chip_smoke.py, by path: a parent checkout has one too."""
    spec = importlib.util.spec_from_file_location("k3_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(root):
    sys.path.insert(0, str(root))
    from gpflowpilco_torch.ops import _build

    took = _build.build_all(LIBS)
    cs, out = _smoke(), getattr(_build, "compiler_output", {})
    ptxas = {lib: cs.ptxas_report(out.get(lib, ""), kernels)
             for lib, kernels in zip(LIBS, (cs.PTXAS_K3, cs.PTXAS_K3G))}
    print(json.dumps({"built": str(root), "seconds": took, "ptxas": ptxas}))


def run(root, save):
    import torch

    sys.path.insert(0, str(root))
    from gpflowpilco_torch.ops import gpr_match_cuda as gm
    from gpflowpilco_torch.ops import mm_match_cuda as mc

    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    res, outs = {}, {}
    for kind, sfx, where in CASES:
        dtype = dtypes[sfx]
        key = f"{kind}_{sfx}_{where}"
        if kind.startswith("gpr_"):
            g = cs.gpr_match_grids(cs.gpr_model(cs.GPR_K, cs.GPR_N, cs.D, cs.GPR_R, device, 7), dtype)[0]
            rng = cs.np.random.default_rng(11)
            mx, sxx = (t[None].contiguous() for t in cs.state_moments(rng, cs.GPR_K, cs.D, dtype, device))
            f = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype, device=device)  # noqa: E731
            k, r = cs.GPR_K, cs.GPR_R
            cots = (f(1, k, r), f(1, k, r, r), f(1, k, cs.D, r))
            f1 = gm.gpr_match_reference(g.meta, g, mx, sxx)[0]
            if kind == "gpr_fwd":
                fn = lambda: gm._fwd(g.meta, g, mx, sxx)  # noqa: E731
            else:
                fn = lambda: gm._bwd(g.meta, g, mx, sxx, f1, *cots)  # noqa: E731
            outs[key] = [t.cpu() for t in fn()]
            bound, _ = cs.gpr_match_bound_ms(kind[4:], g.meta, 1, dtype)
            res[key] = dict(ms=cs.median_ms(fn, flush=flush), bound_ms=bound, stages=cs.stage_ms(fn))
            continue
        n, num_l, d, m, unc = cs.MATCH_SHAPES[where]
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
        outs[key] = [t.cpu() for t in (
            out if kind == "fwd" else (*out[:2], *(out[2].tensors() if out[2] is not None else ())))]
        ms = cs.median_ms(fn, flush=flush)
        stages = cs.stage_ms(fn)
        bound, _ = cs.match_bound_ms(kind, g.meta, n, dtype)
        res[key] = dict(ms=ms, bound_ms=bound, stages=stages)
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
    print(f"{'entry':36s}" + "".join(f"{n:>14s}" for n in table))
    for k in table["this"]:
        print(f"{k:36s}" + "".join(f"{table[n][k]['ms']:14.4f}" for n in table))
    for name, rows in table.items():
        for k, row in rows.items():
            print(f"stages {name} {k}: " + ", ".join(f"{s} {v:.4f} ms" for s, v in row["stages"].items()))
    result = {"card": card, "ms": table}
    if args.parent:
        a = torch.load(out_dir / "k3_bench_outputs_this.pt")
        b = torch.load(out_dir / "k3_bench_outputs_parent.pt")
        # True, or {output index: max |this - parent|} of the outputs that differ
        same = {}
        for k in a:
            if k.startswith(("bwd_f", "gpr_fwd_")) and not k.startswith("bwd_frozen"):
                diff = {i: float((x.double() - y.double()).abs().max())
                        for i, (x, y) in enumerate(zip(a[k], b[k])) if not torch.equal(x, y)}
                same[k] = diff or True
        print(f"K3 full backward and K3g forward bit-identical to the parent's: {same}")
        result["bit_identical"] = same
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
