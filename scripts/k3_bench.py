#!/usr/bin/env python3
"""Time K1 (the pathwise drift's path evaluation, csrc/path_eval.cu), K2
(the eKuffu pair contraction, csrc/kexp_pair.cu), K3 (the whole SVGP match,
csrc/mm_match.cu), K3g (the whole GPR match, csrc/gpr_match.cu), K4 (the
encoder match, csrc/enc_match.cu), K5 (the MM step's PSD boost and Euler
update, csrc/mm_glue.cu) and K6 (the whole pathwise rollout loss,
csrc/rollout.cu) on one NVIDIA GPU: this
checkout against others (a parent commit's ``git archive``, a variant), in
one run on one card.

    python scripts/k3_bench.py [--parent DIR] [--other NAME=DIR ...] [--only PREFIX ...] [--out FILE]

All checkouts build first, their ``nvcc`` processes together. Then each
runs in a process of its own, in turns (parent, this, others, then the same
in reverse), and times every K3 entry at the whole-match path's shapes,
K3g's at the HMC ensemble's, and K2's six entries at the MM drift's and
policy's shapes and its forward and frozen backward on the GPR route (P=8
members, R=4), K1's three entries at the pathwise slice's shape (S=1024,
L=4, B=1024, M=240, D=6) in float32 and float64, K5a in float32 and float64 at the policy
joint's shape (N=1, D=6) and K5b at the state's (N=1, D=4): float32 with
the boost (the path's) and without it (no Jacobi sweeps: the loads and
stores alone), float64 without it (the solver's float64 semantics), K4's
forward and backward in float32 and float64 at the rollout's N=1 and the
post-rollout cost's N=30 (D=4, active (1,)), and K6's forward and
backward at the fused-rollout slice's shape (S=1024,
B=1024, M=240, Mp=30, T=30) and on the 8-member axis (K=8, 128 particles
each), with chip_smoke.py's method (median device time over 30 calls, L2
flushed, and warm; chip_smoke's *_bound_ms for the bounds). Each checkout
is reported by the smaller of its medians. On the same inputs, each other
checkout's outputs are compared with this one's: K3g's forward at its bars
(float64: 1e-9 of the scale; float32: within 3x the plain float32
version's error against float64, plus 1e-4 of the scale), K2's forward and
full backward and K1's two backwards at their own (rtol = atol = 1e-10 in
float64, 1e-4 in float32), K4's backward and K5's at chip_smoke.py's
(1e-12 of the scale in float64, 1e-5 in float32; these entries and K2's
and K1's also report whether they are bit-identical), K6's forward and backward at
chip_smoke.py's (float64: 1e-10 of the scale; float32 over 30 steps:
within 3x the plain float32 version's error against float64, plus 1e-4 of
the scale), every other entry (K1's forward, K2's frozen backward among
them) bit for bit. ``--only`` keeps the
entries whose name starts with one of the prefixes (``k6_``: K6 alone,
``k6_fwd``: its forward alone, ``k4_``: K4 alone), and builds only the
libraries they need. Each checkout's per-stage device times
(torch.profiler) and each library's ptxas registers, spills and stack
frames are printed. The last line is one JSON object of all the numbers,
also written to --out.
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
# frozen backward (N=1, P=8, D2=14, M=240, R=4); K1's three entries at the
# pathwise slice's shape in float32 and float64 (a checkout whose K1 takes
# float32 alone times no float64 case); K5a at the policy joint's, K5b at the state's
# with the boost ("state") and without ("sym")
CASES = (
    ("fwd", "f32", "drift"), ("fwd", "f32", "policy"), ("bwd_frozen", "f32", "drift"),
    ("bwd", "f32", "policy"), ("bwd", "f32", "ensemble policy"), ("fwd", "f64", "drift"),
    ("bwd_frozen", "f64", "drift"), ("bwd", "f64", "drift"),
    ("gpr_fwd", "f32", "ensemble"), ("gpr_bwd_frozen", "f32", "ensemble"),
    ("gpr_fwd", "f64", "ensemble"), ("gpr_bwd_frozen", "f64", "ensemble"),
    *((f"k2_{kind}", sfx, where) for sfx in ("f64", "f32") for where in ("drift", "policy")
      for kind in ("fwd", "bwd", "bwd_frozen")),
    *((f"k2_{kind}", sfx, "gpr") for sfx in ("f64", "f32") for kind in ("fwd", "bwd_frozen")),
    *((f"k6_{kind}", sfx, where) for where in ("slice", "members") for sfx in ("f32", "f64")
      for kind in ("fwd", "bwd")),
    *((f"k1_{kind}", sfx, "pathwise") for sfx in ("f32", "f64") for kind in ("fwd", "bwd_dx", "bwd_full")),
    ("k5_psd", "f32", "joint"), ("k5_psd", "f64", "joint"), ("k5_euler", "f32", "state"),
    ("k5_euler", "f32", "sym"), ("k5_euler", "f64", "sym"),
    *((f"k4_{kind}", sfx, where) for sfx in ("f32", "f64") for where in ("rollout", "cost")
      for kind in ("fwd", "bwd")),
)
LIBS = ("mm_match", "gpr_match", "kexp_pair", "rollout", "path_eval", "mm_glue", "enc_match")
# the library of each entry-name prefix; K3's entries ("fwd", "bwd", ...) are mm_match's
PREFIX_LIBS = (("k6_", "rollout"), ("k2_", "kexp_pair"), ("gpr_", "gpr_match"), ("k1_", "path_eval"),
               ("k5_", "mm_glue"), ("k4_", "enc_match"))
K6_MEMBERS = 8  # the HMC ensemble's members on K6's member axis
K2_GPR = (1, 8, 14, 240, 4)  # (N, P, D2, M, R) of K2's GPR route
K4_N = {"rollout": 1, "cost": 30}  # K4's batch in the rollout and on the post-rollout cost


def _smoke():
    """This checkout's chip_smoke.py, by path: a parent checkout has one too."""
    spec = importlib.util.spec_from_file_location("k3_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def libs_of(only):
    """The libraries the entries kept by the ``--only`` prefixes need."""
    if not only:
        return LIBS
    kinds = [kind for kind, _, _ in CASES if kind.startswith(tuple(only))]
    return tuple(lib for lib in LIBS if any(
        next((pl for pre, pl in PREFIX_LIBS if kind.startswith(pre)), "mm_match") == lib for kind in kinds))


def build(root, libs):
    sys.path.insert(0, str(root))
    from gpflowpilco_torch.ops import _build

    took = _build.build_all(libs)
    cs, out = _smoke(), getattr(_build, "compiler_output", {})
    # older checkouts' names: fwd_tiles, K3g's forward tile kernel;
    # fwd_kernel and bwd_kernel, K6's forward and backward and K2's and K1's
    # forwards; K2's two-pass full backward and frozen tiles; K4's
    # one-thread forward and backward
    kernels = {"mm_match": cs.PTXAS_K3, "gpr_match": (*cs.PTXAS_K3G, "fwd_tiles"),
               "kexp_pair": (*cs.PTXAS_K2, "fwd_kernel", "bwd_cols_kernel", "bwd_rows_kernel",
                             "bwd_frozen_tiles", "bwd_frozen_finish"),
               "rollout": (*cs.PTXAS_K6, "fwd_kernel", "bwd_kernel"),
               "path_eval": (*cs.PTXAS_K1, "fwd_kernel"), "mm_glue": cs.PTXAS_K5,
               "enc_match": (*cs.PTXAS_K4, "enc_fwd_kernel", "enc_bwd_kernel")}
    ptxas = {lib: cs.ptxas_report(out.get(lib, ""), kernels[lib]) for lib in libs}
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


def _k4_case(cs, ec, kind, dtype, where, device):
    """(fn, bound) of a K4 entry on chip_smoke.py's encoder inputs."""
    import torch

    n = K4_N[where]
    rng = cs.np.random.default_rng(17 + n)
    meta = ec.make_enc_meta(cs.ENC_ACTIVE, cs.ENC_D)
    mx, sxx = cs.state_moments(rng, n, cs.ENC_D, dtype, device)
    bound = cs.enc_bound_ms(kind, n, cs.ENC_D, len(cs.ENC_ACTIVE), dtype)[0]
    if kind == "fwd":
        return (lambda: ec._fwd(meta, mx, sxx)), bound
    f = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype, device=device)  # noqa: E731
    de = meta.num_out
    cots = (f(n, de), f(n, de, de), f(n, cs.ENC_D, de))
    return (lambda: ec._bwd(meta, mx, sxx, *cots)), bound


def _k1_case(cs, pe, kind, dtype, device):
    """(fn, bound) of a K1 entry on chip_smoke's kernel inputs."""
    t = cs.kernel_inputs(11, device, dtype=dtype)
    ops = tuple(t[k] for k in ("x", "w", "v", "omega", "phase", "z_scaled", "z2", "inv_ls"))
    bound, _ = cs.bound_ms({"fwd": "fwd", "bwd_dx": "dx", "bwd_full": "full"}[kind], dtype=dtype)
    if kind == "fwd":
        return (lambda: (pe._fwd(*ops),)), bound
    if kind == "bwd_dx":
        return (lambda: (pe._bwd_dx(*ops, t["g"]),)), bound
    return (lambda: pe._bwd_full(*ops, t["g"])), bound


def _k5_case(cs, gc, kind, dtype, where, device):
    """(fn, bound) of a K5 entry on chip_smoke's glue inputs: K5a on an
    indefinite policy joint, K5b with the float32 solver's boost ("state")
    or without it ("sym")."""
    import torch

    rng = cs.np.random.default_rng(13)
    if kind == "psd":
        s6 = cs.state_moments(rng, 1, cs.GLUE_JOINT_D, dtype, device, shift=-0.3)[1]
        return (lambda: (gc._psd(s6, 0.0),)), cs.glue_bound_ms("psd", 1, cs.GLUE_JOINT_D, dtype)[0]
    m4, s4 = cs.state_moments(rng, 1, 4, dtype, device, shift=-0.3)
    f14, sff4 = cs.state_moments(rng, 1, 4, dtype, device)
    sxf4 = torch.as_tensor(0.1 * rng.normal(size=(1, 4, 4)), dtype=dtype, device=device)
    jitter = 1e-6 if where == "state" else 0.0
    return (lambda: gc._euler(m4, s4, f14, sff4, sxf4, 1.0, jitter)), cs.glue_bound_ms("euler", 1, 4, dtype)[0]


def _k6_case(cs, rc, kind, dtype, where, device, outs, key):
    """(fn, bound) of a K6 entry on chip_smoke's rollout operands; in
    float32 also the plain float32 and float64 outputs (the bars)."""
    import torch

    k = K6_MEMBERS if where == "members" else 1
    meta, ops = cs.rollout_operands(rc, k, cs.S, 1, cs.L, 1, cs.HORIZON_STEPS, dtype, device, 4000 + k)
    bound, _ = cs.rollout_bound_ms(kind, meta, ops, dtype)
    if kind == "fwd":
        if dtype == torch.float32:
            outs[f"{key}/plain"] = [t.cpu() for t in rc._rollout(meta, *ops)]
            outs[f"{key}/truth"] = [t.cpu() for t in rc._rollout(meta, *(o.double() for o in ops))]
        return (lambda: rc._fwd(meta, *ops)), bound
    gl = torch.full((cs.S,), 1.0 / cs.S, dtype=dtype, device=device)
    traj = rc._fwd(meta, *ops)[1]
    if dtype == torch.float32:
        outs[f"{key}/plain"] = [t.cpu() for t in rc.rollout_reference_bwd(meta, traj, gl, *ops[1:])]
        ops64 = tuple(o.double() for o in ops)
        traj64 = rc._rollout(meta, *ops64)[1]
        outs[f"{key}/truth"] = [t.cpu() for t in rc.rollout_reference_bwd(meta, traj64, gl.double(), *ops64[1:])]
    return (lambda: rc._bwd(meta, traj, gl, *ops[1:])), bound


def run(root, save, only=()):
    import torch

    sys.path.insert(0, str(root))
    from gpflowpilco_torch.ops import enc_match_cuda as ec
    from gpflowpilco_torch.ops import gpr_match_cuda as gm
    from gpflowpilco_torch.ops import kexp_cuda as kc
    from gpflowpilco_torch.ops import mm_glue_cuda as gc
    from gpflowpilco_torch.ops import mm_match_cuda as mc
    from gpflowpilco_torch.ops import path_eval_cuda as pe
    from gpflowpilco_torch.ops import rollout_cuda as rc

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
        if only and not kind.startswith(tuple(only)):
            continue
        dtype = dtypes[sfx]
        key = f"{kind}_{sfx}_{where}"
        if kind.startswith("k6_"):
            fn, bound = _k6_case(cs, rc, kind[3:], dtype, where, device, outs, key)
            outs[key] = [t.cpu() for t in fn()]
            timed(key, fn, bound)
            continue
        if kind.startswith("k1_") and dtype == torch.float64 and "path_eval_fwd_f64" not in pe.launches:
            continue  # this checkout's K1 takes float32 alone
        if kind.startswith(("k1_", "k2_", "k4_", "k5_")):
            fn, bound = (_k1_case(cs, pe, kind[3:], dtype, device) if kind.startswith("k1_")
                         else _k5_case(cs, gc, kind[3:], dtype, where, device) if kind.startswith("k5_")
                         else _k4_case(cs, ec, kind[3:], dtype, where, device) if kind.startswith("k4_")
                         else _k2_case(cs, kc, kind[3:], dtype, where, device))
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
        if not k.startswith(("gpr_fwd_", "k2_fwd", "k2_bwd_f32", "k2_bwd_f64", "k1_bwd", "k4_", "k5_", "k6_")):
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
        elif k.startswith("k6_"):
            if "_f64_" in k:
                ok = all(cs.scaled_err(x, y) <= cs.ROLL_F64_TOL for x, y in pairs)
            else:
                truth, plain = a[f"{k}/truth"], a[f"{k}/plain"]
                ok = all(cs.scaled_err(x, t) <= 3.0 * cs.scaled_err(p, t) + 1e-4
                         for side in (a[k], b[k]) for x, p, t in zip(side, plain, truth))
            out[k] = dict(scaled_vs_parent=max(cs.scaled_err(x, y) for x, y in pairs), bars_hold=ok)
        elif k.startswith(("k4_", "k5_")):
            tol = cs.SMALL_TOL[torch.float64 if "_f64_" in k else torch.float32]
            err = max(cs.scaled_err(x, y) for x, y in pairs)
            out[k] = dict(scaled_vs_parent=err, bars_hold=err <= tol,
                          bit_identical=all(torch.equal(x, y) for x, y in pairs))
        else:  # K2's forward and full backward, K1's backwards
            tol = cs.PAIR_TOL[torch.float64 if "_f64_" in k else torch.float32]
            out[k] = dict(max_abs_vs_parent=max(float((x.double() - y.double()).abs().max()) for x, y in pairs),
                          bars_hold=all(torch.allclose(x, y, rtol=tol, atol=tol) for x, y in pairs),
                          bit_identical=all(torch.equal(x, y) for x, y in pairs))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--parent", default=None, help="a checkout to time beside this one")
    p.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                   help="another checkout to time in the same turns")
    p.add_argument("--only", action="append", default=[], metavar="PREFIX",
                   help="time only the entries whose name starts with PREFIX (k6_, k2_, gpr_, ...)")
    p.add_argument("--out", default=str(ROOT / "build" / "k3_bench" / "k3_bench.json"))
    p.add_argument("--build", nargs="+", metavar="ROOT [LIB ...]", help=argparse.SUPPRESS)
    p.add_argument("--run", nargs="+", metavar="ROOT SAVE [PREFIX ...]", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.build:
        return build(Path(args.build[0]), args.build[1:])
    if args.run:
        return run(Path(args.run[0]), args.run[1], args.run[2:])

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
    procs = [subprocess.Popen([*me, "--build", str(r), *libs_of(args.only)], stdout=subprocess.PIPE, text=True)
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
            for kern, t, params, regs, st, ld, stack in rows:
                print(f"ptxas {name} {lib} {kern}<{t}{''.join(f', {v}' for v in params)}>: {regs} registers, "
                      f"spill {st} / {ld} bytes, stack frame {stack} bytes")
    order = [*roots, *reversed(roots)]
    out_dir = Path(args.out).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {}
    for i, name in enumerate(order):
        save = out_dir / f"k3_bench_outputs_{name}.pt"
        proc = subprocess.run([*me, "--run", str(roots[name]), str(save), *args.only], stdout=subprocess.PIPE,
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
