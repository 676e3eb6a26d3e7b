#!/usr/bin/env python3
"""Time K2 (the eKuffu pair contraction, csrc/kexp_pair.cu), K3 (the whole
SVGP match, csrc/mm_match.cu) and K3g (the whole GPR match,
csrc/gpr_match.cu) on one NVIDIA GPU: this checkout against others (a
parent commit's ``git archive``, a variant), in one run on one card.

    python scripts/k3_bench.py [--parent DIR] [--other NAME=DIR ...] [--out FILE]

All checkouts build first, their ``nvcc`` processes together. Then each
runs in a process of its own, in turns (parent, this, others, then the same
in reverse), and times every K3 entry at the whole-match path's shapes,
K3g's at the HMC ensemble's, and K2's six entries at the MM drift's and
policy's shapes and its forward and frozen backward on the GPR route (P=8
members, R=4), with chip_smoke.py's method (median device time over 30
calls, L2 flushed, and warm; chip_smoke's *_bound_ms for the bounds).
Each checkout is reported by the smaller of its medians. On the same
inputs, each other checkout's outputs are compared with this one's: K3g's
forward at its bars (float64: 1e-9 of the scale; float32: within 3x the
plain float32 version's error against float64, plus 1e-4 of the scale),
K2's frozen backward at its own (rtol = atol = 1e-10 in float64, 1e-4 in
float32), every other entry bit for bit. Each checkout's per-stage
device times (torch.profiler) and each library's ptxas registers and spills
are printed. The last line is one JSON object of all the numbers, also
written to --out.
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
# forward and frozen backward at the ensemble's shape (K=8, N=240, D=6,
# R=4); K2's six entries at the MM drift's (N=1, P=10, D2=14, M=240) and
# policy's (N=1, P=1, D2=12, M=30) shapes, and the GPR route's forward and
# frozen backward (N=1, P=8, D2=14, M=240, R=4)
CASES = (
    ("fwd", "f32", "drift"), ("fwd", "f32", "policy"), ("bwd_frozen", "f32", "drift"),
    ("bwd", "f32", "policy"), ("bwd", "f32", "ensemble policy"), ("fwd", "f64", "drift"),
    ("bwd_frozen", "f64", "drift"), ("bwd", "f64", "drift"),
    ("gpr_fwd", "f32", "ensemble"), ("gpr_bwd_frozen", "f32", "ensemble"),
    ("gpr_fwd", "f64", "ensemble"), ("gpr_bwd_frozen", "f64", "ensemble"),
    *((f"k2_{kind}", sfx, where) for sfx in ("f64", "f32") for where in ("drift", "policy")
      for kind in ("fwd", "bwd", "bwd_frozen")),
    *((f"k2_{kind}", sfx, "gpr") for sfx in ("f64", "f32") for kind in ("fwd", "bwd_frozen")),
)
LIBS = ("mm_match", "gpr_match", "kexp_pair")
K2_GPR = (1, 8, 14, 240, 4)  # (N, P, D2, M, R) of K2's GPR route


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
    # fwd_tiles: an older checkout's name of K3g's forward tile kernel
    kernels = {"mm_match": cs.PTXAS_K3, "gpr_match": (*cs.PTXAS_K3G, "fwd_tiles"), "kexp_pair": cs.PTXAS_K2}
    ptxas = {lib: cs.ptxas_report(out.get(lib, ""), kernels[lib]) for lib in LIBS}
    print(json.dumps({"built": str(root), "seconds": took, "ptxas": ptxas}))


def _k2_case(cs, kc, kind, dtype, where, device):
    """(fn, bound) of a K2 entry on chip_smoke's pair inputs."""
    n, p, d2, m, r = K2_GPR if where == "gpr" else (*cs.PAIR_SHAPES[where], 1)
    t = cs.pair_inputs(cs.np.random.default_rng(11 + m + r), n, p, d2, m, dtype, device, r=r)
    ops, cot = (t["su"], t["sw"], t["alu"], t["qm"]), (t["devc"], t["dqcol"])
    bound, _ = cs.pair_bound_ms(kind, n, p, d2, m, dtype, r=r)
    if kind == "fwd":
        return (lambda: kc._fwd(*ops)), bound
    return (lambda: kc._bwd(*ops, *cot, kind == "bwd")[:2 if kind == "bwd_frozen" else 4]), bound


def run(root, save):
    import torch

    sys.path.insert(0, str(root))
    from gpflowpilco_torch.ops import gpr_match_cuda as gm
    from gpflowpilco_torch.ops import kexp_cuda as kc
    from gpflowpilco_torch.ops import mm_match_cuda as mc

    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    res, outs = {}, {}

    def timed(key, fn, bound):
        res[key] = dict(ms=cs.median_ms(fn, flush=flush), warm_ms=cs.median_ms(fn), bound_ms=bound,
                        stages=cs.stage_ms(fn))

    for kind, sfx, where in CASES:
        dtype = dtypes[sfx]
        key = f"{kind}_{sfx}_{where}"
        if kind.startswith("k2_"):
            fn, bound = _k2_case(cs, kc, kind[3:], dtype, where, device)
            outs[key] = [t.cpu() for t in fn()]
            timed(key, fn, bound)
            continue
        if kind.startswith("gpr_"):
            g, g64 = cs.gpr_match_grids(cs.gpr_model(cs.GPR_K, cs.GPR_N, cs.D, cs.GPR_R, device, 7), dtype)
            rng = cs.np.random.default_rng(11)
            mx, sxx = (t[None].contiguous() for t in cs.state_moments(rng, cs.GPR_K, cs.D, dtype, device))
            f = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype, device=device)  # noqa: E731
            k, r = cs.GPR_K, cs.GPR_R
            cots = (f(1, k, r), f(1, k, r, r), f(1, k, cs.D, r))
            f1 = gm.gpr_match_reference(g.meta, g, mx, sxx)[0]
            if kind == "gpr_fwd":
                fn = lambda: gm._fwd(g.meta, g, mx, sxx)  # noqa: E731
                # the plain version's outputs, and float64's, for the bars
                outs[f"{key}/plain"] = [t.cpu() for t in gm.gpr_match_reference(g.meta, g, mx, sxx)]
                outs[f"{key}/truth"] = [t.cpu() for t in gm.gpr_match_reference(
                    g64.meta, g64, mx.double(), sxx.double())]
            else:
                fn = lambda: gm._bwd(g.meta, g, mx, sxx, f1, *cots)  # noqa: E731
            outs[key] = [t.cpu() for t in fn()]
            timed(key, fn, cs.gpr_match_bound_ms(kind[4:], g.meta, 1, dtype)[0])
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
        timed(key, fn, cs.match_bound_ms(kind, g.meta, n, dtype)[0])
    torch.save(outs, save)
    print(json.dumps(res))


def compare(a, b, cs):
    """This checkout's outputs ``a`` against another's ``b``: per entry,
    for the entries held at bars the largest difference and whether the
    bars hold, for the others True (bit-identical) or {output: max |a - b|}
    of the outputs that differ."""
    import torch

    out = {}
    for k in a:
        if "/" in k or k not in b:
            continue
        pairs = list(zip(a[k], b[k]))
        if not k.startswith(("gpr_fwd_", "k2_bwd_frozen")):
            diff = {i: float((x.double() - y.double()).abs().max()) for i, (x, y) in enumerate(pairs)
                    if not torch.equal(x, y)}
            out[k] = diff or True
        elif k.startswith("gpr_fwd_"):
            truth, plain = a[f"{k}/truth"], a[f"{k}/plain"]
            if "_f64_" in k:
                ok = all(cs.scaled_err(x, p) <= cs.MATCH_F64_TOL for x, p in zip(a[k], plain))
            else:
                ok = all(cs.scaled_err(x, t) <= 3.0 * cs.scaled_err(p, t) + 1e-4
                         for x, p, t in zip(a[k], plain, truth))
            out[k] = dict(scaled_vs_parent=max(cs.scaled_err(x, y) for x, y in pairs), bars_hold=ok)
        elif k.startswith("k2_bwd_frozen"):
            tol = 1e-10 if "_f64_" in k else 1e-4
            out[k] = dict(max_abs_vs_parent=max(float((x.double() - y.double()).abs().max()) for x, y in pairs),
                          bars_hold=all(torch.allclose(x, y, rtol=tol, atol=tol) for x, y in pairs))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--parent", default=None, help="a checkout to time beside this one")
    p.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                   help="another checkout to time in the same turns")
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
    cs = _smoke()
    card = cs.card_line()
    print(f"card: {card}")
    roots = {}
    if args.parent:
        roots["parent"] = Path(args.parent).resolve()
    roots["this"] = ROOT
    for item in args.other:
        name, _, path = item.partition("=")
        roots[name] = Path(path).resolve()
    me = [sys.executable, str(Path(__file__).resolve())]
    procs = [subprocess.Popen([*me, "--build", str(r)], stdout=subprocess.PIPE, text=True)
             for r in roots.values()]
    builds = {}
    for name, proc in zip(roots, procs):
        lines = proc.communicate()[0].strip().splitlines()
        print(f"build {name}: {lines[-1] if lines else ''}")
        if proc.returncode:
            sys.exit("k3_bench: a build failed")
        builds[name] = json.loads(lines[-1])
    for name, b in builds.items():
        for lib, rows in b["ptxas"].items():
            for kern, t, params, regs, st, ld in rows:
                print(f"ptxas {name} {lib} {kern}<{t}{''.join(f', {v}' for v in params)}>: {regs} registers, "
                      f"spill {st} / {ld} bytes")
    order = [*roots, *reversed(roots)]
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
                    warm_ms=min(r[k]["warm_ms"] for r in rs), bound_ms=rs[0][k]["bound_ms"],
                    stages=rs[0][k]["stages"])
            for k in rs[0]
        }
    print(f"{'entry':40s}" + "".join(f"{n:>14s}" for n in table) + "   (ms, L2 flushed; warm)")
    for k in table["this"]:
        print(f"{k:40s}" + "".join(
            f"{table[n][k]['ms']:8.4f} ({table[n][k]['warm_ms']:.4f})" if k in table[n] else f"{'':>14s}"
            for n in table))
    for name, rows in table.items():
        for k, row in rows.items():
            print(f"stages {name} {k}: " + ", ".join(f"{s} {v:.4f} ms" for s, v in row["stages"].items()))
    result = {"card": card, "ms": table, "ptxas": {n: b["ptxas"] for n, b in builds.items()}}
    a = torch.load(out_dir / "k3_bench_outputs_this.pt")
    for name in roots:
        if name == "this":
            continue
        same = compare(a, torch.load(out_dir / f"k3_bench_outputs_{name}.pt"), cs)
        print(f"this against {name} (True: bit-identical): {same}")
        result[f"against_{name}"] = same
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
