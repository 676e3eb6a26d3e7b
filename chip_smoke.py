#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (gpflowpilco_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--step-limit 50] [--lbfgs-iters 100] [--profile DIR]

1. Refuses to run without CUDA; prints the card's name and power limit.
2. Builds every CUDA kernel from the sources in this checkout (one nvcc per
   source, all started together) and prints the build time.
3. Kernels, on inputs made from --seed with numpy, each held against its
   plain torch version on the same inputs and timed beside it:
   - K1 (path eval: K1a forward, K1b dx-only backward, K1c full backward)
     at the pathwise path's shapes: S=1024 particles, L=4 latents, B=1024
     Fourier bases, M=240 inducing points, D=6, in float32 and float64
     (rows ``*_f64``); K1c's dx bit for bit K1b's, its repeats
     bit-identical;
   - K2 (eKuffu pair contraction: forward, full and frozen backward) in
     float32 and float64 at the MM path's two shapes: the drift's N=1,
     P=10 latent pairs, D2=14, M=240 and the policy's N=1, P=1, D2=12, M=30;
     each entry's repeated runs bit-identical, and the device time of its
     stages (tiles and, above one tile, finish) printed.
4. Pathwise slice: pathwise PILCO on cartpole at full width (1024 particles x
   1024 bases, horizon 30, up to 240 inducing points), its SVGP paths through
   K1 (use_fused_paths, as run_torch.py --fused): 8 random episodes
   through outer_loop, then one iteration (L-BFGS drift fit, Adam policy
   update, one RK4 episode). The launch counts are zeroed just before that
   iteration and read just after; each kernel the path runs must have run.
   Then the float64 K1 hold (f64_paths_phase): PathwisePILCO in float64
   with use_fused_paths at the trained policy and drift, its loss+grad
   through K1a and K1b in float64 (30 + 30 launches, counted from zero)
   against the unfused float64 path at the same paths and x0 (bar
   max(1e-9, 10x the unfused loss's rounding noise), cosine >= 0.9999), and
   ms per float64 loss+grad.
5. MM slice: moment-matching PILCO on cartpole at full width (drift M=240,
   policy M=30, horizon 30) with the pair-grid kernel (use_fused_mm), the
   float64 loss with the policy chain as a float32 island: 8 random
   episodes, an L-BFGS drift fit, then one Adam policy update and one RK4
   episode. The counts are zeroed just before the policy update and read
   just after: per Adam step, 30 float64 forward and 30 frozen backward
   launches (the drift match) and 30 float32 forward and 30 full backward
   launches (the policy match). At the trained policy the 30-step float64
   MM loss through the kernel and through the unfused eKuffu must agree to
   1e-9 relative, or to 10x the loss's own rounding noise where that is
   larger (mm_loss_noise).
6. Whole-match kernels: K3 (the whole SVGP match: forward, frozen and full
   backward) at the drift's (N=1, L=4, D=6, M=240, with model uncertainty),
   the policy's (N=1, L=1, D=5, M=30) and the HMC ensemble policy's (the
   policy's with the 8 members as its batch, N=8) shapes, K4 (the encoder
   match; its forward's and backward's repeated runs bit-identical) at N=1
   and N=30, K5a (the PSD boost) at D=6 and K5b (the Euler update; its
   repeated runs bit-identical) at D=4, each in
   float32 and float64 against its plain version, timed beside
   it, its bound and, for K5a and K5b, torch.linalg.eigvalsh. Float32 K3 is
   held twice: at a random model's grid against float64, and at a
   well-conditioned grid of the same shape against plain float32 at a fixed
   bar. K3's frozen backward is also held at N=8 (the batch on its block
   grid), repeated forward and frozen-backward runs, and full-backward runs
   at N=8, must be bit-identical, and the device time of each stage of the
   tiled entries (tile sweep, finish, combine) and of the full backward
   (groups, slot sum, combine), and of K4's and K5b's entries, is printed
   from one profiler session. K5's kernels sweep D <= 8 in the round-robin order,
   the plain version in the cyclic one: where five cyclic sweeps have not
   converged, K5 is held
   against eigvalsh's lambda_min at the same bar
   (mm_glue_cuda.boosted_reference). The build prints ptxas's registers,
   spills and stack frames of every kernel and fails if a float32 tile
   kernel at the main path's register capacity spills (K3's and K3g's at 8,
   K2's forward and backward tiles at 16, K1's forward and both backwards
   and K6's forward at 6 and 8, K6's Jacobians at 8), or if K4's forward
   or backward or K5b's kernel at the path's D = 4 spills or has a stack
   frame.
7. Whole-match slice: moment-matching PILCO on cartpole at full width with
   use_fused_match, float32 loop and loss: 8 random episodes, a drift fit,
   then one Adam policy update (counts zeroed just before, read just after;
   per Adam step 60 K3 forwards, 30 frozen and 30 full K3 backwards, 31 K4
   forwards and 30 backwards, 30 K5a and 30 K5b, no K1 or K2) and one RK4
   episode. Then the 30-step float64 loss with every whole-match kernel
   against the unfused one (bar max(1e-9, 10x the loss's rounding noise,
   10x the Jacobi-vs-eigvalsh lambda_min gap)), from the episode's x0 and
   from x0 with an indefinite covariance, where the first steps' policy
   joints are indefinite and the PSD boost must act at one step at least;
   one float32 step fused
   against unfused (both against float64), and, printed only, the float32
   losses and gradient cosines against float64.
8. Slice-B kernels: K3g (the whole GPR match: forward and frozen backward)
   and K2's GPR route (forward and frozen backward with R=4 rows and the 8
   members on the pair axis) at K=8 members, N=240, D=6, R=4, in float32
   and float64 against their plain versions (K2's float64 GPR route also at
   the members' noise, GPR_NOISE), timed beside them and their bounds;
   K3g's repeated forward and backward runs must be bit-identical, and so
   must K2's GPR-route forward's, full and frozen backward's; the device time
   of each of K3g's stages (forward tiles and combine; backward tile sweep,
   finish, combine) and of K2's GPR-route forward and frozen backward
   (tiles, finish) is printed.
9. HMC-ensemble slice (slice B): cartpole at full width with an exact GPR
   drift: 8 random episodes (N=240), an L-BFGS MAP fit, HMC with 8 chains
   (warmup, samples and leapfrog cut to HMC_CUT) thinned to an 8-member
   GPREnsemble; prints the HMC time, its acceptance and the host syncs and
   jitter-escalation levels of one leapfrog step's evaluation at the
   members' states. Then (a) a whole-match ensemble MM policy update in
   float32: per Adam step 30 K3g forwards and 30 frozen backwards, each one
   launch for all 8 members, beside the policy's K3, K4 and K5 launches of
   the whole-match slice, no K1 or K2; (b) one float64 loss+grad with
   use_fused_mm: 30 float64 K2 forwards and frozen backwards (the drift's
   GPR grid, R=4) and 30 float32 forwards and full backwards (the policy
   island), the loss held against the same loss through K2's plain version
   and against the unfused float64 loss, each with 5's bar; (c) one
   pathwise ensemble loss+grad (1024 particles over 8 members, 1024 bases)
   and a PW_STEPS policy update, in plain torch as in the JAX package (no
   kernel launches), and (d) the same update with use_fused_rollout: one K6
   forward and one backward per step for all 8 members; then the float64
   loss and gradient through K6 against the per-step GPR path at the same
   paths and x0 (the bar of 10).
10. K6 (the whole pathwise rollout loss, forward and backward) at the
   pathwise slice's widths (S=1024, B=1024, M=240, Mp=30, 30 steps) in
   float32 and float64 against its plain version (rollout_kernels_phase),
   also at S=1000, at the LCK shape and on the 8-member axis, the float32
   forward's ring route bit-identical to its resident one, timed beside it
   and its bound; then the fused-rollout slice: the pathwise slice's loop
   with use_fused_rollout, a policy update (one K6 forward and one backward
   per Adam step, no K1), and at that state the float64 loss and gradient
   through K6 against the unfused float64 path at the same paths and x0
   (bar max(1e-9, 10x the loss's rounding noise), cosine >= 0.9999), and,
   printed, the float32 gradients' cosines.
11. Policy loop (policy_loop_phase), on the fused-rollout slice's loop at
   full width: (a) a K=4 multistart update through K6 with the
   best-validated snapshot as candidate 1 (4 x --step-limit K6 forwards
   and backwards, no K1; the snapshot bit-identical afterwards), (b) a K=2
   x 5-step multistart through K1 (2 x 5 x 30 K1a forwards and as many K1b
   dx-only backwards, no K1c or K6), (c) 100-rollout validation with the
   cartpole success mask, 3 rollouts held against serial ones (1e-5
   relative, float32), (d) a checkpoint saved and restored into a fresh
   loop (episodes and q_mu bit-identical, one K6 loss equal bit for bit).
12. Scale-out (scaleout_phase, slice E) on the policy loop's fitted loop at
   full width: (i) world size 1 over NCCL in this process: the sharded
   step's loss and gradient through K1 (route (b)) and K6 (route (c))
   against PathwisePILCO.policy_loss_fn on the same draws (1e-6 relative,
   cosine >= 0.99999) with their launch counts, Adam steps sharded and
   unsharded in turns, timed, and the float64 K6 loss sharded against
   unsharded (1e-10); (iii) sharded HMC and resampling against the local
   ones at that world size; (ii) two gloo ranks on the one card (NCCL
   refuses two ranks on one device), route (c) at 512 particles a rank,
   held against (i) by the same bars and timed.
13. Slice-D kernels: every entry on the double pendulum's paths at its
   shapes, held against its plain version by the bars of 3, 6 and 10, timed
   beside it and its bound, rows named ``<entry>/dp``: K1a/K1b in float32
   and float64 at the drift's S=1024, L=4, B=1024, M=320, D=8 (and,
   ``/mc``, mountain car's L=2, M=128, D=3), K1c held there untimed; K2 at the drift's N=1, P=10, D2=18, M=320 (D2 > 16:
   the DM = 32 route, whose ptxas report is printed) and the policy's P=3,
   D2=14, M=100; K3 at the drift's L=4, D=8, M=320 and the policy's L=2,
   D=6, M=100 (the full backward at the policy's shape only, where the
   path runs it: the drift match is frozen); K4 with both angles active
   (NA=2) at N=1 and N=50; K5a at the policy joint's D=8; K6 at DXU=8,
   M=320, Mp=100, T=50 (the float32 forward's resident route, its ring
   route bit-identical).
14. Tasks (tasks_phase): the double pendulum and mountain car at full
   width through their runners, each update's counts zeroed just before
   and read just after: (a) the double pendulum pathwise, through K6 and
   then K1, an RK4 episode, the float64 K6 loss and gradient against the
   per-step path; (b) its MM updates through K2 (float64 loss) and the
   whole-match kernels, each float64 loss against the unfused one; (c)
   mountain car's MM update through K2, pathwise update through K1 and an
   RK4 episode; (d) the 'adam' and 'natgrad_adam' drift fits beside
   L-BFGS's ELBO.
15. Prints the kernels' JSON line, then {"ok": true, "device": {...}} as the
   last line. Any failed check raises, so the exit code is non-zero.

Tolerances of the kernel checks, rtol = atol:
- K1, 1e-4 in float32 and 1e-10 in float64: the kernel and its plain
  version both sum ~1024 terms of size ~0.05 per output, in different
  orders and with differently rounded cos/sin/exp arguments; the expected
  gap is ~1e-6 in float32 (~1e-14 in float64), so the bars leave room
  without hiding a wrong index or term.
- K2, 1e-4 in float32 and 1e-10 in float64: each output is a sum of at most
  240 terms (times a 14-term exponent) taken in another order than the
  plain version's, so the gap is a few ulps of the sum's size.
- K3, K4, K5a, K5b: see match_kernels_phase (relative to each output's
  scale; float32 K3 against a float64 truth).
- K6: see rollout_kernels_phase (float64 1e-10 of the scale; float32 1e-4
  of the scale over 5 steps, and against a float64 truth over 30).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RTOL = ATOL = 1e-4
S, L, B, M, D = 1024, 4, 1024, 240, 6
HORIZON_STEPS = 30
# K2's shapes on the MM path, (N, P, D2, M): the drift match (P = L(L+1)/2
# latent pairs, D2 = 2*(5 features + 1 action) + 2) and the policy match
PAIR_SHAPES = {"drift": (1, L * (L + 1) // 2, 2 * D + 2, M), "policy": (1, 1, 2 * 5 + 2, 30)}
PAIR_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# the MM path runs the drift match in float64 and the policy match in float32
PAIR_MAIN = {torch.float64: "drift", torch.float32: "policy"}
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # H100 SXM, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def sync():
    torch.cuda.synchronize()


def graph_captures() -> int:
    """Captures of the particle loss's CUDA graphs so far in the process
    (gpflowpilco_torch/ops/graphs.py). Each warms up with one K6 forward and
    one backward beyond its steps' own, so a count of K6 launches over n
    steps is n plus the captures made meanwhile."""
    from gpflowpilco_torch.utils import tracing

    return tracing.counters()["graphs.captures"]


def median_ms(fn, reps=30, flush=None, hold_s=0.2):
    """Median device time of fn over reps calls (CUDA events), each after an
    L2 flush when ``flush`` is given, after a warm-up.

    The device first spins for ``hold_s`` while the host enqueues every call,
    so the events time the device's work and not the host's launch overhead
    (a ctypes launch or a plain-torch call costs tens of microseconds of
    Python, more than one kernel takes). The warm-up runs every kernel of
    the timed calls once, because CUDA loads a kernel lazily at its first
    launch and that waits for the device. Raises if enqueueing outlasted the
    hold, since the times would then include host gaps."""
    torch.cuda._sleep(1000)
    for _ in range(3):
        if flush is not None:
            flush.zero_()
        fn()
    sync()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]
    t0 = time.perf_counter()
    torch.cuda._sleep(int(hold_s * 1.98e9))  # cycles at the H100's top SM clock
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    enqueue_s = time.perf_counter() - t0
    sync()
    if enqueue_s > 0.5 * hold_s:
        raise AssertionError(f"enqueueing {reps} calls took {enqueue_s:.3f} s, hold {hold_s} s")
    return statistics.median(start.elapsed_time(end) for start, end in events)


def plain_ms_of(fn, flush, reps=5, hold_s=3.0):
    """(ms, how) of a plain-torch or library call: its device time by
    median_ms, or, when the call waits for the device itself (a host
    synchronization inside, so enqueueing cannot run ahead of the device),
    the median host wall time of one call between two synchronizations."""
    try:
        return median_ms(fn, reps=reps, flush=flush, hold_s=hold_s), "device"
    except AssertionError:
        walls = []
        for _ in range(reps):
            flush.zero_()
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(walls), "wall"


def _bound(bytes_moved, ops, dtype):
    """Least time on an H100 SXM at 700 W for work that moves ``bytes_moved``
    over 3.35 TB/s and does ``ops`` operations at the peak vector rate of
    ``dtype`` (FP32 67, FP64 34 TFLOP/s), whichever is larger. Returns
    (ms, 'bytes' | 'operations')."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound_ms(kind, shape=(S, L, B, M, D), dtype=torch.float32):
    """Least time of one K1 launch at ``shape`` (S, L, B, M, D) in ``dtype``:
    the bytes it must move (each input read once, each output written once)
    and its operations (_bound)."""
    S, L, B, M, D = shape  # noqa: N806
    inputs = S * D + S * L * (B + M) + L * (B * D + B + M * D + M + D)
    outputs = S * L
    # per (s, l, b): the D-term dot and the sum; per (s, l, m): the dot, the
    # distance and the sum. The backward adds a D-term update per b and m.
    flops = S * L * (B * (2 * D + 2) + M * (2 * D + 6))
    if kind != "fwd":
        inputs += S * L  # g
        outputs = S * D
        flops = S * L * (B * (4 * D + 4) + M * (4 * D + 8))
    if kind == "full":
        outputs += S * L * (B + M)
    return _bound((inputs + outputs) * (torch.finfo(dtype).bits // 8), flops, dtype)


def kernel_inputs(seed, device, shape=(S, L, B, M, D), dtype=torch.float32):
    S, L, B, M, D = shape  # noqa: N806
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()  # noqa: E731
    ls = 1.0 + rng.uniform(size=(L, D))
    il = 1.0 / ls
    z = rng.normal(size=(L, M, D)) * ls[:, None, :]  # inducing inputs spread over ~1 lengthscale
    z_scaled = z * il[:, None, :]
    return dict(
        x=f(1.5 * rng.normal(size=(S, D))),
        w=f(rng.normal(size=(S, L, B)) * math.sqrt(2.0 / B)),
        v=f(0.1 * rng.normal(size=(S, L, M))),
        omega=f(rng.normal(size=(L, B, D)) * il[:, None, :]),
        phase=f(rng.uniform(0.0, 2.0 * math.pi, size=(L, B))),
        z_scaled=f(z_scaled),
        z2=f(np.sum(z_scaled**2, axis=-1)),
        inv_ls=f(il),
        g=f(rng.normal(size=(S, L))),
    )


def check(name, got, want, tol=RTOL):
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=tol, atol=tol)
    print(f"  {name}: max|kernel - plain| = {err:.3e}  ({'ok' if ok else 'FAILED'})")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max err {err})")
    return err


K1_TOL = {torch.float32: RTOL, torch.float64: 1e-10}


def kernels_phase(pe, seed, device, shape=(S, L, B, M, D), sfx="", full=True):
    """Hold K1a, K1b and K1c against the plain version at ``shape`` (S, L,
    B, M, D) in float32 and float64 (K1_TOL), K1c's dx against K1b's bit for
    bit and each entry's repeat against its first run; time K1a and K1b,
    and with ``full`` K1c, beside the plain version, and each launch's own
    device time (stage_ms). The rows' names end in ``sfx``, the float64
    rows' in ``_f64`` before it."""
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)  # > 50 MB L2
    errs, timings = {}, {}
    for dtype, key in ((torch.float32, ""), (torch.float64, "_f64")):
        t = kernel_inputs(seed, device, shape, dtype)
        ops = (t["x"], t["w"], t["v"], t["omega"], t["phase"], t["z_scaled"], t["z2"], t["inv_ls"])
        g = t["g"]
        tol = K1_TOL[dtype]
        want_f = pe.path_eval_reference(*ops)
        want_dx, want_dw, want_dv = pe.path_eval_reference_bwd(*ops, g, want_wv=True)
        got_f = pe._fwd(*ops)
        got_dx = pe._bwd_dx(*ops, g)
        full_dx, got_dw, got_dv = pe._bwd_full(*ops, g)
        sync()
        print("kernels at S={} L={} B={} M={} D={} {}, rtol=atol={}:".format(*shape, str(dtype)[6:], tol))
        name = {e: f"{e}{key}{sfx}" for e in pe.ENTRIES}
        errs[name["path_eval_fwd"]] = check(f"{name['path_eval_fwd']} f", got_f, want_f, tol)
        errs[name["path_eval_bwd_dx"]] = check(f"{name['path_eval_bwd_dx']} dx", got_dx, want_dx, tol)
        errs[name["path_eval_bwd_full"]] = max(
            check(f"{name['path_eval_bwd_full']} dx", full_dx, want_dx, tol),
            check(f"{name['path_eval_bwd_full']} dw", got_dw, want_dw, tol),
            check(f"{name['path_eval_bwd_full']} dv", got_dv, want_dv, tol),
        )
        if not torch.equal(full_dx, got_dx):
            raise AssertionError(f"{name['path_eval_bwd_full']}: K1c's dx differs from K1b's")
        repeats = (torch.equal(got_f, pe._fwd(*ops)) and torch.equal(got_dx, pe._bwd_dx(*ops, g))
                   and all(torch.equal(a, c) for a, c in zip((full_dx, got_dw, got_dv), pe._bwd_full(*ops, g))))
        if not repeats:
            raise AssertionError(f"K1{key}{sfx}: repeated runs differ")
        print("  K1c's dx equals K1b's bit for bit; repeated runs of K1a, K1b and K1c bit-identical")
        calls = {
            "path_eval_fwd": (lambda: pe._fwd(*ops), lambda: pe.path_eval_reference(*ops), "fwd"),
            "path_eval_bwd_dx": (
                lambda: pe._bwd_dx(*ops, g),
                lambda: pe.path_eval_reference_bwd(*ops, g, want_wv=False),
                "dx",
            ),
            "path_eval_bwd_full": (
                lambda: pe._bwd_full(*ops, g),
                lambda: pe.path_eval_reference_bwd(*ops, g, want_wv=True),
                "full",
            ),
        }
        for entry, (kern, plain, kind) in calls.items():
            if kind == "full" and not full:
                continue
            row = name[entry]
            ms = median_ms(kern, flush=flush)
            warm_ms = median_ms(kern)
            plain_ms = median_ms(plain, reps=10, flush=flush)
            bound, bound_by = bound_ms(kind, shape, dtype)
            timings[row] = dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms, plain_how="device", bound_ms=bound,
                                bound_by=bound_by)
            print(
                f"  {row}: {ms:.4f} ms cold-L2 median ({warm_ms:.4f} ms warm), "
                f"plain torch {plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})"
            )
            times = timings[row]["stages"] = stage_ms(kern)
            print(f"  stages of {row}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    return errs, timings


def pair_bound_ms(kind, n, p, d2, m, dtype, r=1):
    """Least time of one K2 launch: each input read once and each output
    written once, and its operations (an exp counts as one) (_bound)."""
    size = torch.finfo(dtype).bits // 8
    grid = n * p * m * m  # (i, j) entries of E, recomputed by every pass
    inputs = 2 * n * p * d2 * m + p * r * m + p * m * m
    if kind == "fwd":
        outputs = n * p * r * m + n * p * m
        # exponent dot, exp, the alu and qm products
        ops = grid * (2 * d2 + 1 + 2 * r + 2)
    else:
        inputs += n * p * r * m + n * p * m  # devc, dqcol
        outputs = 2 * n * p * d2 * m
        # E again, dE = alu devc + qm dqcol, g = -E dE, dsu and dsw
        ops = grid * (2 * d2 + 1 + 2 * r + 2 + 1 + 4 * d2)
        if kind == "bwd":
            outputs += p * r * m + p * m * m  # dalu, dqm
            ops += grid * (2 * r + 1)
    return _bound((inputs + outputs) * size, ops, dtype)


def pair_inputs(rng, n, p, d2, m, dtype, device, r=1):
    """su, sw >= 0 with exponents su^T sw of order 1 (E spans ~e^0..e^-5, as
    in the pair grid), alu (r rows), qm and the backward's cotangents."""
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()  # noqa: E731
    scale = 1.5 / math.sqrt(d2)
    return dict(
        su=f(np.abs(rng.normal(size=(n, p, d2, m))) * scale),
        sw=f(np.abs(rng.normal(size=(n, p, d2, m))) * scale),
        alu=f(rng.normal(size=(p, r, m))),
        qm=f(rng.normal(size=(p, m, m))),
        devc=f(rng.normal(size=(n, p, r, m))),
        dqcol=f(rng.normal(size=(n, p, m))),
    )


def pair_kernels_phase(kc, seed, device, shapes=PAIR_SHAPES, tag=""):
    """Hold K2's six entries against the plain version at both MM shapes and
    time each at the shape the main path gives it (float64 at the drift's,
    float32 at the policy's); the rows' names end in ``tag``."""
    rng = np.random.default_rng(seed + 1000)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)
    errs = {name: 0.0 for name in kc.launches}
    timings = {}
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        tol = PAIR_TOL[dtype]
        for where, (n, p, d2, m) in shapes.items():
            t = pair_inputs(rng, n, p, d2, m, dtype, device)
            ops = (t["su"], t["sw"], t["alu"], t["qm"])
            cot = (t["devc"], t["dqcol"])
            want_fwd = kc.pair_contract_reference(*ops)
            want_bwd = kc.pair_contract_reference_bwd(*ops, *cot, True)
            got = {
                "fwd": kc._fwd(*ops),
                "bwd": kc._bwd(*ops, *cot, True),
                "bwd_frozen": kc._bwd(*ops, *cot, False),
            }
            sync()
            print(f"pair contract {where} N={n} P={p} D2={d2} M={m} {sfx}, rtol=atol={tol}:")
            outs = {
                "fwd": zip(("evc", "qcol"), got["fwd"], want_fwd),
                "bwd": zip(("dsu", "dsw", "dalu", "dqm"), got["bwd"], want_bwd),
                "bwd_frozen": zip(("dsu", "dsw"), got["bwd_frozen"][:2], want_bwd[:2]),
            }
            for kind, triples in outs.items():
                name = f"pair_contract_{kind}_{sfx}"
                for out, g, w in triples:
                    errs[name] = max(errs[name], check(f"{name} {out}", g, w, tol))
            pair_repeats(kc, ops, cot, sfx)
            if PAIR_MAIN[dtype] != where:
                continue
            calls = {
                "fwd": (lambda: kc._fwd(*ops), lambda: kc.pair_contract_reference(*ops)),
                "bwd": (lambda: kc._bwd(*ops, *cot, True),
                        lambda: kc.pair_contract_reference_bwd(*ops, *cot, True)),
                "bwd_frozen": (lambda: kc._bwd(*ops, *cot, False),
                               lambda: kc.pair_contract_reference_bwd(*ops, *cot, False)),
            }
            for kind, (kern, plain) in calls.items():
                name = f"pair_contract_{kind}_{sfx}"
                ms = median_ms(kern, flush=flush)
                warm_ms = median_ms(kern)
                plain_ms = median_ms(plain, reps=10, flush=flush)
                bound, bound_by = pair_bound_ms(kind, n, p, d2, m, dtype)
                timings[name + tag] = dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms, plain_how="device",
                                           bound_ms=bound, bound_by=bound_by)
                print(f"  {name}{tag}: {ms:.4f} ms cold-L2 median ({warm_ms:.4f} ms warm), "
                      f"plain torch {plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
            # each entry's stages (warm L2): tiles and, above one tile, finish
            for kind in ("fwd", "bwd", "bwd_frozen"):
                times = stage_ms(calls[kind][0])
                timings[f"pair_contract_{kind}_{sfx}{tag}"]["stages"] = times
                print(f"  stages of pair_contract_{kind}_{sfx}{tag}: "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    return {k + tag: v for k, v in errs.items()}, timings


def pair_repeats(kc, ops, cot, sfx, where=""):
    """Two runs of each of K2's forward, full and frozen backward must be
    bit-identical."""
    for kind, fn in (("fwd", lambda: kc._fwd(*ops)), ("bwd", lambda: kc._bwd(*ops, *cot, True)),
                     ("bwd_frozen", lambda: kc._bwd(*ops, *cot, False)[:2])):
        name = f"pair_contract_{kind}_{sfx}{where}"
        if not all(torch.equal(a, b) for a, b in zip(fn(), fn())):
            raise AssertionError(f"{name}: repeated runs differ")
        print(f"  {name}: repeated runs bit-identical")


def slice_phase(pe, seed, device, step_limit, lbfgs_iters):
    """8 random episodes, then one full-width pathwise PILCO iteration."""
    from run_torch import build_loop

    from gpflowpilco_torch.loops.driver import outer_loop
    from gpflowpilco_torch.loops.pilco import DriftSpec, PolicySpec
    from gpflowpilco_torch.models.pathwise import (
        PathState,
        PathwiseSVGPTransform,
        generate_paths_svgp,
    )

    loop = build_loop(
        seed, device, torch.float32,
        drift_spec=DriftSpec(num_centers=M, max_iters=lbfgs_iters),
        policy_spec=PolicySpec(
            batch_size=S, num_bases=B, num_restarts=1, step_limit=step_limit
        ),
    )
    loop.use_fused_paths = True  # the SVGP paths through K1, as run_torch.py --fused
    assert loop.episode_spec.num_steps == HORIZON_STEPS
    t0 = time.perf_counter()
    outer_loop(loop, num_episodes=8, num_episodes_init=8, log_summaries=False)
    sync()
    print(f"slice: 8 random episodes in {time.perf_counter() - t0:.2f} s "
          f"({sum(len(e.actions) for e in loop.episodes)} transitions)")
    print(f"slice: L-BFGS max_iters={lbfgs_iters}, Adam step_limit={step_limit}, "
          f"particles={S}, bases={B}, horizon={HORIZON_STEPS}")

    # ---- the main path: counts zeroed just before, read just after
    pe.reset_launches()
    t0 = time.perf_counter()
    info_d = loop.update_dynamics()
    sync()
    t_dyn = time.perf_counter() - t0
    m_drift = loop.drift_model.num_inducing
    print(f"slice: drift fit {1e3 * t_dyn:.1f} ms, loss {info_d['loss']:.4f}, "
          f"{info_d['iters']} iterations, M={m_drift}")
    assert math.isfinite(info_d["loss"]), "drift fit loss is not finite"
    assert m_drift == M, f"drift has M={m_drift}, expected {M}"

    loop.policy_model = loop.build_policy()
    before = {n: p.detach().clone() for n, p in loop.policy_model.named_parameters()}
    counts0 = dict(pe.launches)
    t0 = time.perf_counter()
    info_p = loop.update_policy()
    sync()
    t_pol = time.perf_counter() - t0
    delta = {k: pe.launches[k] - counts0[k] for k in pe.launches}
    print(f"slice: policy update {1e3 * t_pol:.1f} ms = {1e3 * t_pol / step_limit:.2f} ms "
          f"per policy step; loss {info_p['loss']:.5f}, skipped {info_p['skipped_steps']}; "
          f"launches {delta}")
    assert math.isfinite(info_p["loss"]), "policy loss is not finite"
    want = HORIZON_STEPS * step_limit
    assert delta["path_eval_fwd"] == want, f"K1a ran {delta['path_eval_fwd']} times, expected {want}"
    assert delta["path_eval_bwd_dx"] == want, (
        f"K1b ran {delta['path_eval_bwd_dx']} times, expected {want}"
    )
    assert delta["path_eval_bwd_full"] == 0, "K1c ran during policy optimization"
    moved = max(
        float((p.detach() - before[n]).abs().max())
        for n, p in loop.policy_model.named_parameters() if p.requires_grad
    )
    assert moved > 0, "policy parameters did not change"

    t0 = time.perf_counter()
    ep = loop.step()
    sync()
    t_ep = time.perf_counter() - t0
    launches = dict(pe.launches)
    print(f"slice: RK4 episode {1e3 * t_ep:.1f} ms, reward {ep.metrics['rewards']:.4f}")
    assert ep.states.shape == (HORIZON_STEPS + 1, 4) and np.isfinite(ep.states).all()
    assert np.all(np.abs(ep.actions) <= 10.0)

    # ---- output check at the trained policy, on fresh paths and initial
    # states: at every state of a 30-step particle rollout, the drift through
    # the kernel and the plain float32 drift are both held against a float64
    # evaluation of the same paths; the kernel's error may be at most 3x
    # the plain version's (plus 1e-6 of the drift's scale). Fitted
    # lengthscales make both float32 results lose digits in the
    # |x|^2+|z|^2-2x.z expansion and in large RFF phases, so a fixed
    # tolerance between the two would test the conditioning, not the kernel.
    with torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        drift = loop.policy_loss_drift()
        paths = generate_paths_svgp(drift, gen, S, B)
        x0 = loop.episode_spec.sample(gen, (S,), dtype=torch.float32, device=device)
        fused_fn = PathwiseSVGPTransform(drift, paths, fused=True)
        plain_fn = PathwiseSVGPTransform(drift, paths, fused=False)
        exact_fn = PathwiseSVGPTransform(
            copy.deepcopy(drift).double(), PathState(*(p.double() for p in paths)), fused=False
        )
        pol = loop.policy_chain(loop.policy_model)
        x, err_kernel, err_plain, scale = x0, 0.0, 0.0, 0.0
        for _ in range(HORIZON_STEPS):
            e = loop.encode(x)
            eu = torch.cat([e, pol(e)], dim=-1)
            f_exact = exact_fn(eu.double())
            f_plain, f_fused = plain_fn(eu), fused_fn(eu)
            assert torch.isfinite(f_fused).all(), "drift through the kernel is not finite"
            err_kernel = max(err_kernel, float((f_fused.double() - f_exact).abs().max()))
            err_plain = max(err_plain, float((f_plain.double() - f_exact).abs().max()))
            scale = max(scale, float(f_exact.abs().max()))
            x = x + f_plain
        losses = {
            name: float(loop._particle_rollout_loss(loop.policy_model, fn, x0))
            for name, fn in (("kernel", fused_fn), ("plain", plain_fn))
        }
    print(f"slice: drift over a 30-step rollout vs float64: max abs error kernel {err_kernel:.3e}, "
          f"plain float32 {err_plain:.3e} (drift scale {scale:.3e}); 30-step loss via kernel "
          f"{losses['kernel']:.6f}, plain {losses['plain']:.6f}")
    assert err_kernel <= 3.0 * err_plain + 1e-6 * scale, "the kernel is less accurate than plain"
    assert all(math.isfinite(v) for v in losses.values()), "the particle loss is not finite"
    return loop, launches, dict(dynamics_ms=1e3 * t_dyn, policy_step_ms=1e3 * t_pol / step_limit,
                                episode_ms=1e3 * t_ep)


F64_TIMED_STEPS = 3  # float64 loss+grad calls timed through K1 after the hold


def f64_paths_phase(pe, loop, seed, device):
    """The float64 K1 hold on the pathwise slice's trained loop: a float64
    PathwisePILCO with use_fused_paths (as run_torch.py --f64 --fused)
    evaluates policy_loss_fn's loss and policy gradient through K1a and
    K1b in float64, counts zeroed just before and read just after (30 + 30
    launches, no float32 or K1c launch), against the unfused float64 path
    at the same paths and x0 (drawn from one generator seed): the loss
    within max(1e-9, 10x the unfused loss's rounding noise, x0 moved by
    1e-14, 1e-13 and 1e-12), the gradient at cosine >= 0.9999. Then
    F64_TIMED_STEPS more loss+grad calls through K1, timed. Returns (the
    float64 rows' launches over the phase, its numbers)."""
    from run_torch import build_loop

    loop64 = build_loop(seed, device, torch.float64, policy_spec=loop.policy_spec)
    drift64 = copy.deepcopy(loop.policy_loss_drift()).double()
    policy64 = copy.deepcopy(loop.policy_model).double()
    x0 = loop64.episode_spec.sample(torch.Generator(device=device).manual_seed(seed + 3), (S,),
                                    dtype=torch.float64, device=device)

    def loss_and_grad(fused, x0_):
        loop64.use_fused_paths = fused
        policy64.zero_grad(set_to_none=True)
        loss = loop64.policy_loss_fn(policy64, torch.Generator(device=device).manual_seed(seed + 4),
                                     drift=drift64, x0=x0_)
        loss.backward()
        return float(loss.detach()), _flat_grads(policy64)

    pe.reset_launches()
    l_k, g_k = loss_and_grad(True, x0)
    sync()
    delta = dict(pe.launches)
    want = {**dict.fromkeys(delta, 0), "path_eval_fwd_f64": HORIZON_STEPS, "path_eval_bwd_dx_f64": HORIZON_STEPS}
    print(f"pathwise f64: one float64 loss+grad through K1, launches {delta}")
    assert delta == want, f"pathwise f64: launches {delta}, expected {want}"
    l_u, g_u = loss_and_grad(False, x0)
    with torch.no_grad():
        loop64.use_fused_paths = False
        gen = lambda: torch.Generator(device=device).manual_seed(seed + 4)  # noqa: E731
        noise = max(abs(float(loop64.policy_loss_fn(policy64, gen(), drift=drift64, x0=x0 + dx)) - l_u) / abs(l_u)
                    for dx in (1e-14, 1e-13, 1e-12))
    rel, bar = abs(l_k - l_u) / abs(l_u), max(1e-9, 10.0 * noise)
    cos64 = float(g_k @ g_u / (g_k.norm() * g_u.norm()))
    print(f"pathwise f64: {HORIZON_STEPS}-step float64 loss via K1 {l_k:.15f}, unfused {l_u:.15f}, relative gap "
          f"{rel:.3e}; unfused rounding noise {noise:.3e}, bar {bar:.3e}; gradient cosine {cos64:.12f}")
    assert math.isfinite(l_k) and rel <= bar, "pathwise f64: K1 and unfused float64 losses disagree"
    assert cos64 >= 0.9999, "pathwise f64: K1 and unfused float64 gradients disagree"
    pe.reset_launches()
    loss_and_grad(True, x0)  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(F64_TIMED_STEPS):
        loss_and_grad(True, x0)
    sync()
    step_ms = 1e3 * (time.perf_counter() - t0) / F64_TIMED_STEPS
    launches = {k: v for k, v in pe.launches.items() if k.endswith("_f64")}
    print(f"pathwise f64: {step_ms:.2f} ms per float64 loss+grad through K1 ({F64_TIMED_STEPS} timed); "
          f"launches over {F64_TIMED_STEPS + 1} calls {launches}")
    assert launches["path_eval_fwd_f64"] == launches["path_eval_bwd_dx_f64"] == (F64_TIMED_STEPS + 1) * HORIZON_STEPS
    policy64.zero_grad(set_to_none=True)
    return launches, dict(f64_rel_gap=rel, f64_noise=noise, f64_grad_cos=cos64, f64_loss_grad_ms=step_ms)


def mm_losses(loop, paths=(("kernel", True), ("unfused", False))):
    """The MM loss of the loop's policy, all in float64 (the policy chain
    too), through the pair-grid kernel and through the unfused eKuffu."""
    spec = loop.policy_spec
    loop.policy_spec = dataclasses.replace(spec, loss_policy_f32=False)
    losses = {}
    try:
        with torch.no_grad():
            for name, fused in paths:
                loop.use_fused_mm = fused
                losses[name] = float(loop.policy_loss_fn(loop.policy_model, None))
    finally:
        loop.use_fused_mm, loop.policy_spec = True, spec
    return losses


def mm_loss_noise(loop, base, deltas=(1e-14, 1e-13, 1e-12)):
    """The rounding noise of the float64 MM loss at this checkpoint: the
    largest relative move of the unfused loss when the initial mean moves by
    each of ``deltas`` (1e-14 to 1e-12), far too little for the loss's
    derivative to show. At a
    fitted M=240 drift the expected-covariance term var - sum(Q * eKuffu)
    cancels digits (Q = Kuu^-1 - ... has large entries of both signs), so
    two correct evaluations in another order differ well above 1e-16."""
    spec = loop.episode_spec
    moves = []
    try:
        for delta in deltas:
            loop.episode_spec = spec._replace(state_mean=np.asarray(spec.state_mean) + delta)
            moved = mm_losses(loop, paths=(("unfused", False),))["unfused"]
            moves.append(abs(moved - base) / abs(base))
    finally:
        loop.episode_spec = spec
    return max(moves)


def mm_slice_phase(kc, seed, device, step_limit, lbfgs_iters):
    """8 random episodes, then one full-width MM PILCO iteration through the
    pair-grid kernel, with the float64 loss and a float32 policy island."""
    from run_torch import build_loop

    from gpflowpilco_torch.loops.driver import outer_loop
    from gpflowpilco_torch.loops.pilco import DriftSpec, MomentMatchingPILCO, PolicySpec

    loop = build_loop(
        seed, device, torch.float32,
        drift_spec=DriftSpec(num_centers=M, max_iters=lbfgs_iters),
        policy_spec=PolicySpec(loss_dtype=torch.float64, num_restarts=1, step_limit=step_limit),
        loop_cls=MomentMatchingPILCO,
    )
    loop.use_fused_mm = True
    assert loop.episode_spec.num_steps == HORIZON_STEPS
    t0 = time.perf_counter()
    outer_loop(loop, num_episodes=8, num_episodes_init=8, log_summaries=False)
    sync()
    print(f"mm slice: 8 random episodes in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    info_d = loop.update_dynamics()
    sync()
    t_dyn = time.perf_counter() - t0
    m_drift = loop.drift_model.num_inducing
    print(f"mm slice: drift fit {1e3 * t_dyn:.1f} ms, loss {info_d['loss']:.4f}, "
          f"{info_d['iters']} iterations, M={m_drift}; Adam step_limit={step_limit}, "
          f"horizon={HORIZON_STEPS}, loss float64, policy island float32")
    assert math.isfinite(info_d["loss"]), "drift fit loss is not finite"
    assert m_drift == M, f"drift has M={m_drift}, expected {M}"

    # ---- the main path: counts zeroed just before, read just after
    loop.policy_model = loop.build_policy()
    assert loop.policy_model.num_inducing == 30
    before = {n: p.detach().clone() for n, p in loop.policy_model.named_parameters()}
    kc.reset_launches()
    t0 = time.perf_counter()
    info_p = loop.update_policy()
    sync()
    t_pol = time.perf_counter() - t0
    delta = dict(kc.launches)
    print(f"mm slice: policy update {1e3 * t_pol:.1f} ms = {1e3 * t_pol / step_limit:.2f} ms "
          f"per MM policy step; loss {info_p['loss']:.6f}, skipped {info_p['skipped_steps']}; "
          f"launches {delta}")
    assert math.isfinite(info_p["loss"]), "MM policy loss is not finite"
    want = dict.fromkeys(kc.launches, 0)
    for name in ("pair_contract_fwd_f64", "pair_contract_bwd_frozen_f64",
                 "pair_contract_fwd_f32", "pair_contract_bwd_f32"):
        want[name] = HORIZON_STEPS * step_limit
    assert delta == want, f"K2 launches {delta}, expected {want}"
    moved = max(
        float((p.detach() - before[n]).abs().max())
        for n, p in loop.policy_model.named_parameters() if p.requires_grad
    )
    assert moved > 0, "policy parameters did not change"

    t0 = time.perf_counter()
    ep = loop.step()
    sync()
    t_ep = time.perf_counter() - t0
    launches = dict(kc.launches)
    # the episode's eReward metric evaluates the MM loss once, forward only
    want = {k: v + (HORIZON_STEPS if k in ("pair_contract_fwd_f64", "pair_contract_fwd_f32") else 0)
            for k, v in delta.items()}
    assert launches == want, f"K2 launches after the episode {launches}, expected {want}"
    print(f"mm slice: RK4 episode {1e3 * t_ep:.1f} ms, reward {ep.metrics['rewards']:.4f}, "
          f"model-predicted {ep.metrics.get('eReward', float('nan')):.4f}")
    assert ep.states.shape == (HORIZON_STEPS + 1, 4) and np.isfinite(ep.states).all()

    # ---- output check: the 30-step MM loss at the trained policy in float64
    # (policy chain too), through the kernel and through the unfused eKuffu
    # to 1e-9 relative, or to 10x the loss's own rounding noise where that is
    # larger (see mm_loss_noise)
    losses = mm_losses(loop)
    rel = abs(losses["kernel"] - losses["unfused"]) / abs(losses["unfused"])
    noise = mm_loss_noise(loop, losses["unfused"])
    bar = max(1e-9, 10.0 * noise)
    qmax = float(loop.policy_loss_drift().cache.qmat.abs().max())
    print(f"mm slice: 30-step float64 MM loss via the kernel {losses['kernel']:.15f}, "
          f"unfused {losses['unfused']:.15f}, relative gap {rel:.3e}; the unfused loss's "
          f"rounding noise {noise:.3e} (max |Q| of the drift {qmax:.3e}), bar {bar:.3e}")
    assert math.isfinite(losses["kernel"]) and rel <= bar, "fused and unfused MM losses disagree"
    return loop, launches, dict(dynamics_ms=1e3 * t_dyn, policy_step_ms=1e3 * t_pol / step_limit,
                                episode_ms=1e3 * t_ep)


# ---------------------------------------------------------------- whole match
# The whole-match path's shapes: K3 at the drift's (N=1, L=4 latents over the
# 5 features and the action, M=240, with model uncertainty), the policy's
# (N=1, L=1, D=5, M=30, deterministic) and the HMC ensemble policy's (the
# policy match with the 8 members as its batch, N=8); K4 at N=1 in the
# rollout and N=30 on the post-rollout cost; K5a on the policy joint (D=6),
# K5b on the state (D=4). Each shape is (N, L, D, M, model uncertainty,
# whether the full backward is held there)
MATCH_SHAPES = {"drift": (1, L, D, M, True, True), "policy": (1, 1, 5, 30, False, True),
                "ensemble policy": (8, 1, 5, 30, False, True)}
MATCH_F64_TOL = 1e-9  # K3 float64, of each output's scale: sums of M^2 terms, 6 x 6 adjoints
# K3 float32 against plain float32 on the well-conditioned grid, of each
# output's scale: there the plain float32 version itself misses float64 by a
# few 1e-6 (sums of 57600 terms of both signs), so two float32 orders differ
# by about as much
MATCH_WC_TOL = 2e-5
WC_STATE_SHIFT = 4.0  # the well-conditioned grid's state covariance, ~4 I
SMALL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # K4, K5: a few dozen terms per output
ENC_ACTIVE, ENC_D, GLUE_JOINT_D = (1,), 4, 6


def match_grid(num_latent, d, m, unc, dtype, device, seed):
    """The whole-match grid of a random SVGP at the path's widths: inducing
    points by k-means on random data, q_mu and a perturbed q_sqrt from the
    seed (so Q is not zero); built in float64 and cast."""
    from gpflowpilco_torch.models.builders import build_svgp
    from gpflowpilco_torch.moment_matching.gp import svgp_match_cache
    from gpflowpilco_torch.ops import mm_match_cuda as mc

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_svgp(f(1.5 * rng.normal(size=(2 * m, d))), f(rng.normal(size=(2 * m, num_latent))),
                       num_inducing=m, generator=gen, noise_variance=0.1)
    with torch.no_grad():
        model.q_mu.copy_(f(0.5 * rng.normal(size=tuple(model.q_mu.shape))))
        model.q_sqrt.copy_(f(0.3 * np.eye(m) + np.tril(0.05 * rng.normal(size=(num_latent, m, m)))))
        grid = svgp_match_cache(model, fused_match=True, uncertainty=unc).match_grid
    return mc.FusedMatchGrid(
        **{k: v.to(dtype).contiguous() for k, v in zip(mc.GRID_FIELDS, grid.tensors())}, meta=grid.meta
    )


def well_conditioned(g, rng):
    """The grid ``g`` with O(1) representer weights (alpha and its pair
    copies) and a symmetric Q of entries ~1/M in place of the model's. A
    random M=240 model's Kuu^-1 makes alpha and Q large with both signs, so
    f1, f2 - f1 f1^T and sum(Q o E) cancel digits in float32 in any order;
    with these, and state covariances near the lengthscales' squares, they
    do not."""
    from gpflowpilco_torch.ops import mm_match_cuda as mc

    t = dict(zip(mc.GRID_FIELDS, g.tensors()))
    like = lambda a: torch.as_tensor(a, dtype=g.alpha.dtype, device=g.alpha.device)  # noqa: E731
    alpha = like(rng.normal(size=tuple(g.alpha.shape)))
    q = like(rng.normal(size=tuple(g.qmat.shape))) / g.meta.num_m
    i_idx, j_idx = ([p[k] for p in g.meta.pairs] for k in (0, 1))
    t.update(alpha=alpha, qmat=(0.5 * (q + q.mT)).contiguous(),
             alpha_u=alpha[i_idx].contiguous(), alpha_w=alpha[j_idx].contiguous())
    return mc.FusedMatchGrid(**t, meta=g.meta)


def k3_outputs(mc, g, mx, sxx, cots, kernel):
    """Every K3 entry's outputs at one input, through the kernels or through
    the plain version: fwd (f1, sff, cross), bwd_frozen (dmx, dsxx) and bwd
    (dmx, dsxx, then the grid cotangents in GRID_FIELDS order)."""
    if kernel:
        fwd = mc._fwd(g.meta, g, mx, sxx)
        frozen = mc._bwd(g.meta, g, mx, sxx, fwd[0], *cots, True)[:2]
        full = mc._bwd(g.meta, g, mx, sxx, fwd[0], *cots, False)
    else:
        fwd = mc.match_reference(g.meta, g, mx, sxx)
        frozen = mc.match_reference_bwd(g.meta, g, mx, sxx, *cots, True)[:2]
        full = mc.match_reference_bwd(g.meta, g, mx, sxx, *cots, False)
    return {"fwd": fwd, "bwd_frozen": frozen, "bwd": (*full[:2], *full[2].tensors())}


def state_moments(rng, n, d, dtype, device, shift=0.0):
    a = rng.normal(size=(n, d, d))
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device).contiguous()  # noqa: E731
    return f(0.5 * rng.normal(size=(n, d))), f(0.05 * a @ a.transpose(0, 2, 1) + (0.1 + shift) * np.eye(d))


def match_bound_ms(kind, meta, n, dtype):
    """Least time of one K3 launch: each input read once and each output
    written once, and its operations (an exp counts as one) (_bound). qmat
    is read only with model uncertainty. Each cell (i, j) of a pair's E grid
    counts once: E itself (two D-term dots, the exponent, the exp: 4D + 5),
    in the forward its two contractions, in the backward the row and column
    sums of E * dE (4D + 6) and, for the full one, the grid cotangents'
    (4D + 6). The full backward's kernel evaluates E twice (a row and a
    column pass); the function does not need that, so the bound does not
    count it."""
    num_l, num_p, d, m = meta.num_latent, meta.num_pairs, meta.num_dim, meta.num_m
    size = torch.finfo(dtype).bits // 8
    grid = (num_l + num_p) * d + num_l * (d * m + m + 2) + num_p * (4 * d * m + 4 * m + 1)
    if meta.uncertainty:
        grid += num_l * m * m
    inputs = n * (d + d * d) + grid
    latent = n * num_l * m * (2 * d * d + 6 * d + 4)
    stage = n * num_p * m * (2 * d * d + 8 * d)
    cells = n * num_p * m * m
    if kind == "fwd":
        outputs = n * (num_l + num_l * num_l + d * num_l)
        ops = latent + stage + cells * (4 * d + 5 + 3)
    else:
        inputs += n * (2 * num_l + num_l * num_l + d * num_l)  # f1 and the cotangents
        outputs = n * (d + d * d)
        # the latent and staging work and their adjoints, E once, its sums
        ops = 2 * latent + 2 * stage + cells * (4 * d + 5 + 4 * d + 6)
        if kind == "bwd":
            outputs += grid
            ops += cells * (4 * d + 6)
    return _bound((inputs + outputs) * size, ops, dtype)


def enc_bound_ms(kind, n, d, na, dtype):
    """K4: bytes of the moments, outputs (and cotangents), and the scalar
    graph's operations per batch entry (trig pairs, the stitch)."""
    de = 2 * na + (d - na)
    size = torch.finfo(dtype).bits // 8
    io = n * (d + d * d + de + de * de + d * de)
    ops = n * (30 * na * na + 2 * de * de + 2 * d * de + 10 * na)
    if kind == "bwd":
        io += n * (d + d * d)
        ops = 2 * ops + n * (4 * de * de + 4 * d * de)
    return _bound(io * size, ops, dtype)


def glue_bound_ms(kind, n, d, dtype):
    """K5a/K5b: bytes of the matrices and vectors; five Jacobi sweeps of
    D(D-1)/2 rotations of ~20 + 8(D-2) operations each, plus the update."""
    size = torch.finfo(dtype).bits // 8
    jacobi = 5 * d * (d - 1) // 2 * (20 + 8 * (d - 2))
    if kind == "psd":
        return _bound(n * 2 * d * d * size, n * (jacobi + 2 * d * d), dtype)
    return _bound(n * (3 * d + 4 * d * d) * size, n * (jacobi + 2 * d + 6 * d * d), dtype)


def stage_ms(fn, reps=5, sessions=4):
    """Device ms per launch of each kernel ``fn`` launches, by kernel name:
    the mean over the launches that one torch.profiler session over
    ``reps`` calls after a warm-up recorded (a session can drop some of
    its calls' events, so the total over ``reps`` would undercount). A
    session can also record none of a tiny kernel's launches (K4's, late in
    a long process, intermittently); then another session is taken over ten
    times as many calls, up to ``sessions`` in all, and says so; {} means
    that none recorded any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    total = {}
    for attempt in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps * 10**attempt):
                fn()
            sync()
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
            name = re.search(r"(\w+)<", e.key)
            name = name.group(1) if name else e.key[:40]
            t_us, n = total.get(name, (0.0, 0))
            total[name] = (t_us + us, n + e.count)
        if total:
            break
    if attempt:
        print(f"  stage_ms: {attempt} profiler session(s) recorded no device activity"
              + (f"; session {attempt + 1}, over {reps * 10**attempt} calls, did" if total else ""))
    return {name: t_us / 1e3 / n for name, (t_us, n) in total.items() if n}


# kernels whose ptxas report chip_smoke prints: K3's (csrc/mm_match.cu),
# K3g's (csrc/gpr_match.cu), K1's (csrc/path_eval.cu), K2's
# (csrc/kexp_pair.cu), K4's (csrc/enc_match.cu), K5's (csrc/mm_glue.cu) and
# K6's (csrc/rollout.cu)
PTXAS_K3 = ("svgp_fwd_tiles", "svgp_fwd_combine", "svgp_bwd_tiles", "svgp_bwd_finish", "svgp_bwd_combine",
            "bwd_groups", "svgp_bwd_slots")
PTXAS_K3G = ("gpr_fwd_tiles", "fwd_combine", "gpr_bwd_tiles", "gpr_bwd_finish", "bwd_combine")
PTXAS_K1 = ("fwd_warp", "bwd_warp", "bwd_full_warp", "bwd_finish")
PTXAS_K2 = ("fwd_tiles", "fwd_finish", "bwd_tiles", "bwd_finish")
PTXAS_K4 = ("enc_fwd_warp", "enc_bwd_warp")
PTXAS_K5 = ("psd_kernel", "euler_warp", "euler_kernel")
PTXAS_K6 = ("fwd_panels", "fwd_warp", "bwd_jac", "bwd_maps", "bwd_adjoint", "bwd_grads")
# (library, its kernels, the kernels that must not spill in float32 at the
# main path's register capacities or shapes (their first template integer),
# those, and whether those must also have no stack frame): K3's and K3g's
# tiles at D <= 8 (DM = 8), K2's forward and backward tiles (frozen and
# full) at D2 <= 16 (DM = 16), K1's forward and both backwards at D = 6
# (the cartpole's) and D <= 8, K4's forward and backward and K5b's warp
# kernel at the path's D = 4 (no stack frame either: no local memory),
# K6's phase-1 Jacobian kernel at Dxu <= 8 (DXU = 8) and its forward, both
# routes, at Dxu = 6 and <= 8
PTXAS_LIBS = (("mm_match", PTXAS_K3, ("svgp_fwd_tiles", "svgp_bwd_tiles"), (8,), False),
              ("gpr_match", PTXAS_K3G, ("gpr_fwd_tiles", "gpr_bwd_tiles"), (8,), False),
              ("kexp_pair", PTXAS_K2, ("fwd_tiles", "bwd_tiles"), (16,), False),
              ("enc_match", PTXAS_K4, ("enc_fwd_warp", "enc_bwd_warp"), (4,), True),
              ("path_eval", PTXAS_K1, ("fwd_warp", "bwd_warp", "bwd_full_warp"), (6, 8), False),
              ("mm_glue", PTXAS_K5, ("euler_warp",), (4,), True),
              ("rollout", PTXAS_K6, ("bwd_jac", "fwd_warp"), (6, 8), False))


def ptxas_report(text, kernels=PTXAS_K3):
    """[(kernel, 'f' | 'd', its integer and bool template arguments (the
    register capacity DM or the exact shape first, then a tile side or a
    route), registers, spill stores, spill loads, stack frame)] in bytes
    from nvcc's -Xptxas -v output. A kernel with no type parameter counts as
    'f'; one with no template arguments has none."""
    rows, name, spill = [], None, (0, 0, 0)
    pat = re.compile(r"\d+(" + "|".join(kernels) + r")(?:I([fd])?((?:L[ib]\d+E)*)|E)")
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = pat.search(line)
            name = (m.group(1), m.group(2) or "f",
                    tuple(int(x) for x in re.findall(r"L[ib](\d+)E", m.group(3) or ""))) if m else None
        elif name and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            spill = (nums[1], nums[2], nums[0])
        elif name and "Used" in line and "registers" in line:
            rows.append((*name, int(re.search(r"Used (\d+) registers", line).group(1)), *spill))
            name = None
    return rows


def scaled_err(got, want):
    """max |got - want| / (1 + max |want|)."""
    return float((got.double() - want.double()).abs().max()) / (1.0 + float(want.abs().max()))


def match_kernels_phase(mc, ec, gc, seed, device, shapes=MATCH_SHAPES, enc=(ENC_ACTIVE, ENC_D),
                        joint_d=GLUE_JOINT_D, steps=HORIZON_STEPS, tag=""):
    """Hold every K3, K4, K5a and K5b entry against its plain version in
    float32 and float64 at the path's shapes, and time each beside its plain
    version, its bound and (K5) torch.linalg.eigvalsh on the same batch.

    Bars: float64, 1e-9 (K3) and 1e-12 (K4, K5) of each output's scale.
    float32 K4 and K5, 1e-5 of the scale (the same scalar graph, five
    Jacobi sweeps; mm_glue_cuda.boosted_reference). float32 K3 is held,
    with its plain version, against the float64 plain version of the same
    inputs: the kernel may miss that truth
    by 3x what the plain float32 version does plus 1e-4 of the scale. At
    M=240 the Q o E contraction cancels digits (Q's entries reach 1e3-1e5),
    so a fixed float32 bar there would test the conditioning, not the
    kernel. So float32 K3 is also held against the plain float32 version at
    a fixed bar, MATCH_WC_TOL of the scale, on a well-conditioned grid of the
    same shape (well_conditioned), where a fault of the float instantiation
    alone (a fast exp, a sum in the wrong type) shows.

    ``shapes`` are K3's (the full backward only at those that say so),
    ``enc`` K4's (active dims, D; at N=1 and N=``steps``), ``joint_d``
    K5a's D (K5b's is K4's D), and the rows' names end in ``tag``. The
    float64 full backward is timed at the drift's shape where it is held
    there, else at the policy's."""
    enc_active, enc_d = enc
    rng = np.random.default_rng(seed + 2000)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)
    from gpflowpilco_torch.moments import GaussianMoments, psd_project

    errs = {name: 0.0 for name in (*mc.launches, *ec.launches, *gc.launches)}
    timings, calls, jacobi_gap = {}, {}, {}
    up = lambda ts: [x.double() for x in ts]  # noqa: E731

    def record(name, got, want, what):
        """Keep the max abs error for the JSON line; return the scaled one."""
        err = float((got.double() - want.double()).abs().max())
        errs[name] = max(errs[name], err)
        scaled = scaled_err(got, want)
        print(f"  {name} {what}: max |kernel - plain| = {err:.3e}, scaled {scaled:.3e}")
        return scaled

    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        for where, (n, num_l, d, m, unc, full) in shapes.items():
            g = match_grid(num_l, d, m, unc, dtype, device, seed + m)
            g64 = mc.FusedMatchGrid(**{k: v.double() for k, v in zip(mc.GRID_FIELDS, g.tensors())},
                                    meta=g.meta)
            mx, sxx = state_moments(rng, n, d, dtype, device)
            f = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype, device=device)  # noqa: E731
            cots = (f(n, num_l), f(n, num_l, num_l), f(n, d, num_l))
            print(f"svgp match {where} N={n} L={num_l} D={d} M={m} uncertainty={unc} {sfx}:")
            got = k3_outputs(mc, g, mx, sxx, cots, kernel=True)
            f1 = got["fwd"][0]
            plain = k3_outputs(mc, g, mx, sxx, cots, kernel=False)
            truth = k3_outputs(mc, g64, mx.double(), sxx.double(), up(cots), kernel=False)
            sync()
            names = {"fwd": ("f1", "sff", "cross"), "bwd_frozen": ("dmx", "dsxx")}
            if full:
                names["bwd"] = ("dmx", "dsxx", *mc.GRID_FIELDS)

            def hold(name, outs, got, plain, truth):
                for what, a, b, c in zip(outs, got, plain, truth):
                    err = record(name, a, b, what)
                    ok = torch.isfinite(a).all()
                    if dtype == torch.float64:
                        ok = ok and err <= MATCH_F64_TOL
                    else:
                        err_k, err_p = scaled_err(a, c), scaled_err(b, c)
                        print(f"    vs float64: kernel {err_k:.3e}, plain float32 {err_p:.3e}")
                        ok = ok and err_k <= 3.0 * err_p + 1e-4
                    if not ok:
                        raise AssertionError(f"{name} {what}: kernel disagrees with its plain version")

            for kind, outs in names.items():
                hold(f"svgp_match_{kind}_{sfx}", outs, got[kind], plain[kind], truth[kind])
            if where == "drift":
                # the frozen backward with a batch of 8 on its block grid, by
                # the same bars; then bit-identical repeats of the tiled entries
                n8 = 8
                mx8, sxx8 = state_moments(rng, n8, d, dtype, device)
                cots8 = (f(n8, num_l), f(n8, num_l, num_l), f(n8, d, num_l))
                f1_8 = mc._fwd(g.meta, g, mx8, sxx8)[0]
                print(f"  frozen backward at N={n8}:")
                hold(f"svgp_match_bwd_frozen_{sfx}", ("dmx", "dsxx"),
                     mc._bwd(g.meta, g, mx8, sxx8, f1_8, *cots8, True)[:2],
                     mc.match_reference_bwd(g.meta, g, mx8, sxx8, *cots8, True)[:2],
                     mc.match_reference_bwd(g64.meta, g64, mx8.double(), sxx8.double(), *up(cots8),
                                            True)[:2])
                for kind in ("fwd", "bwd_frozen"):
                    runs = [k3_outputs(mc, g, mx, sxx, cots, kernel=True)[kind] for _ in range(2)]
                    if not all(torch.equal(a, b) for a, b in zip(*runs)):
                        raise AssertionError(f"svgp_match_{kind}_{sfx}: repeated runs differ")
                print(f"  svgp_match_fwd_{sfx}, svgp_match_bwd_frozen_{sfx}: repeated runs bit-identical")
            if where == "ensemble policy":
                # the full backward's batch on the block grid, its slots added in order
                runs = [k3_outputs(mc, g, mx, sxx, cots, kernel=True)["bwd"] for _ in range(2)]
                if not all(torch.equal(a, b) for a, b in zip(*runs)):
                    raise AssertionError(f"svgp_match_bwd_{sfx}: repeated runs differ at N={n}")
                print(f"  svgp_match_bwd_{sfx} at N={n}: repeated runs bit-identical")
            if dtype == torch.float32:
                # the float32 kernel against the plain float32 version at a
                # fixed bar, on a well-conditioned grid of the same shape
                wc = well_conditioned(g, rng)
                mxw, sxxw = state_moments(rng, n, d, dtype, device, shift=WC_STATE_SHIFT)
                got_w = k3_outputs(mc, wc, mxw, sxxw, cots, kernel=True)
                plain_w = k3_outputs(mc, wc, mxw, sxxw, cots, kernel=False)
                sync()
                print(f"  well-conditioned grid, bar {MATCH_WC_TOL:g} of the scale:")
                for kind, outs in names.items():
                    name = f"svgp_match_{kind}_{sfx}"
                    for what, a, b in zip(outs, got_w[kind], plain_w[kind]):
                        err = record(name, a, b, what)
                        if not (torch.isfinite(a).all() and err <= MATCH_WC_TOL):
                            raise AssertionError(f"{name} {what}: kernel disagrees with its plain "
                                                 f"version on the well-conditioned grid")
            # the main path runs K3 in float32: forwards and the frozen backward
            # at the drift's shape, the full backward at the policy's; the
            # float64 entries are timed at the drift's shape
            args = (g.meta, g, mx, sxx)
            if where == "drift":
                calls[f"svgp_match_fwd_{sfx}"] = (
                    lambda a=args: mc._fwd(*a), lambda a=args: mc.match_reference(*a),
                    match_bound_ms("fwd", g.meta, n, dtype), None)
                calls[f"svgp_match_bwd_frozen_{sfx}"] = (
                    lambda a=args, c=cots, f=f1: mc._bwd(*a, f, *c, True),
                    lambda a=args, c=cots: mc.match_reference_bwd(*a, *c, True),
                    match_bound_ms("bwd_frozen", g.meta, n, dtype), None)
            full_where = "drift" if dtype == torch.float64 and shapes["drift"][5] else "policy"
            if where == full_where:
                calls[f"svgp_match_bwd_{sfx}"] = (
                    lambda a=args, c=cots, f=f1: mc._bwd(*a, f, *c, False),
                    lambda a=args, c=cots: mc.match_reference_bwd(*a, *c, False),
                    match_bound_ms("bwd", g.meta, n, dtype), None)
            if where == "policy" and dtype == torch.float32:
                calls["svgp_match_fwd_f32 (policy)"] = (
                    lambda a=args: mc._fwd(*a), lambda a=args: mc.match_reference(*a),
                    match_bound_ms("fwd", g.meta, n, dtype), None)
            if where == "ensemble policy" and dtype == torch.float32:
                calls["svgp_match_bwd_f32 (ensemble policy)"] = (
                    lambda a=args, c=cots, f=f1: mc._bwd(*a, f, *c, False),
                    lambda a=args, c=cots: mc.match_reference_bwd(*a, *c, False),
                    match_bound_ms("bwd", g.meta, n, dtype), None)

        tol = SMALL_TOL[dtype]
        meta = ec.make_enc_meta(enc_active, enc_d)
        de = meta.num_out
        for n in (1, steps):
            mx, sxx = state_moments(rng, n, enc_d, dtype, device)
            f = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype, device=device)  # noqa: E731
            cots = (f(n, de), f(n, de, de), f(n, enc_d, de))
            print(f"encoder match N={n} D={enc_d} active={enc_active} {sfx}, bar {tol:g}:")
            pairs = [("fwd", ("ym", "yc", "cr"), ec._fwd(meta, mx, sxx), ec.enc_match_reference(meta, mx, sxx)),
                     ("bwd", ("dmx", "dsxx"), ec._bwd(meta, mx, sxx, *cots),
                      ec.enc_match_reference_bwd(meta, mx, sxx, *cots))]
            sync()
            for kind, outs, got, want in pairs:
                for what, a, b in zip(outs, got, want):
                    err = record(f"enc_match_{kind}_{sfx}", a, b, what)
                    if not (torch.isfinite(a).all() and err <= tol):
                        raise AssertionError(f"enc_match_{kind}_{sfx} {what}: kernel disagrees")
            for (kind, _, first, _), again in zip(pairs, (ec._fwd(meta, mx, sxx), ec._bwd(meta, mx, sxx, *cots))):
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"enc_match_{kind}_{sfx}: repeated runs differ")
                print(f"  enc_match_{kind}_{sfx}: repeated runs bit-identical")
            if n == 1:
                calls[f"enc_match_fwd_{sfx}"] = (
                    lambda a=(meta, mx, sxx): ec._fwd(*a),
                    lambda a=(meta, mx, sxx): ec.enc_match_reference(*a),
                    enc_bound_ms("fwd", n, enc_d, len(enc_active), dtype), None)
                calls[f"enc_match_bwd_{sfx}"] = (
                    lambda a=(meta, mx, sxx), c=cots: ec._bwd(*a, *c),
                    lambda a=(meta, mx, sxx), c=cots: ec.enc_match_reference_bwd(*a, *c),
                    enc_bound_ms("bwd", n, enc_d, len(enc_active), dtype), None)

        # K5a on indefinite policy joints, K5b on the state with and without the boost
        _, s6 = state_moments(rng, 1, joint_d, dtype, device, shift=-0.3)
        m4, s4 = state_moments(rng, 1, enc_d, dtype, device, shift=-0.3)
        f14, sff4 = state_moments(rng, 1, enc_d, dtype, device)
        sxf4 = torch.as_tensor(0.1 * rng.normal(size=(1, enc_d, enc_d)), dtype=dtype, device=device)
        jitter = 1e-6 if dtype == torch.float32 else 0.0  # the solver's cov_jitter
        print(f"glue: psd boost N=1 D={joint_d}, euler update N=1 D={enc_d} {sfx}, bar {tol:g}:")
        checks = [("psd_boost", "out", gc._psd(s6, 0.0), gc.boosted_reference(0.5 * (s6 + s6.mT), 0.0, tol))]
        for jit in (0.0, 1e-6):
            got = gc._euler(m4, s4, f14, sff4, sxf4, 1.0, jit)
            want = gc.euler_update_reference(m4, s4, f14, sff4, sxf4, 1.0, 0.0)
            checks += [("euler_update", f"mean (jitter {jit:g})", got[0], want[0]),
                       ("euler_update", f"cov (jitter {jit:g})", got[1],
                        gc.boosted_reference(want[1], jit, tol) if jit else want[1])]
        sync()
        for kind, what, a, b in checks:
            err = record(f"{kind}_{sfx}", a, b, what)
            if not (torch.isfinite(a).all() and err <= tol):
                raise AssertionError(f"{kind}_{sfx} {what}: kernel disagrees with its plain version")
        for jit in (0.0, 1e-6):
            first, again = (gc._euler(m4, s4, f14, sff4, sxf4, 1.0, jit) for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"euler_update_{sfx} (jitter {jit:g}): repeated runs differ")
        print(f"  euler_update_{sfx}: repeated runs bit-identical")
        # Jacobi's lambda_min against eigvalsh's where the boost is active:
        # K5a against psd_project on the same indefinite joints
        boosted = gc._psd(s6, 0.0)
        ref = psd_project(GaussianMoments(mean=s6[..., 0], cov=s6)).cov
        jacobi_gap[sfx] = scaled_err(boosted, ref)
        print(f"  psd_boost_{sfx} vs psd_project (eigvalsh) on indefinite joints: scaled gap "
              f"{jacobi_gap[sfx]:.3e}")
        calls[f"psd_boost_{sfx}"] = (
            lambda s=s6: gc._psd(s, 0.0), lambda s=s6: gc.psd_boost_reference(s, 0.0),
            glue_bound_ms("psd", 1, joint_d, dtype), lambda s=s6: torch.linalg.eigvalsh(s))
        eargs = (m4, s4, f14, sff4, sxf4, 1.0, jitter)
        calls[f"euler_update_{sfx}"] = (
            lambda a=eargs: gc._euler(*a), lambda a=eargs: gc.euler_update_reference(*a),
            glue_bound_ms("euler", 1, enc_d, dtype), lambda s=s4: torch.linalg.eigvalsh(s))

    calls = {name + tag: call for name, call in calls.items()}
    for name, (kern, plain, (bound, bound_by), library) in calls.items():
        ms = median_ms(kern, flush=flush)
        warm_ms = median_ms(kern)
        plain_ms, plain_how = plain_ms_of(plain, flush)
        lib_ms, lib_how = (None, None) if library is None else plain_ms_of(library, flush, reps=30)
        timings[name] = dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms, plain_how=plain_how,
                             bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)
        print(f"  {name}: {ms:.4f} ms cold-L2 median ({warm_ms:.4f} ms warm), plain torch "
              f"{plain_ms:.4f} ms ({plain_how}), bound {bound:.6f} ms ({bound_by})"
              + ("" if lib_ms is None else f", eigvalsh {lib_ms:.4f} ms ({lib_how})"))
    # the stages of K3's entries (warm L2): tile sweep, finish, combine; the
    # full backward's groups, slot sum (N > 1) and combine; K4's and K5b's
    # one kernel each, its time alone
    for name in ("svgp_match_fwd_f32", "svgp_match_bwd_frozen_f32", "svgp_match_fwd_f64",
                 "svgp_match_bwd_frozen_f64", "svgp_match_fwd_f32 (policy)", "svgp_match_bwd_f32",
                 "svgp_match_bwd_f32 (ensemble policy)", "enc_match_fwd_f32", "enc_match_fwd_f64",
                 "enc_match_bwd_f32", "enc_match_bwd_f64", "euler_update_f32",
                 "euler_update_f64"):
        name += tag
        if name not in calls:
            continue
        times = stage_ms(calls[name][0])
        timings[name]["stages"] = times
        print(f"  stages of {name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    return {k + tag: v for k, v in errs.items()}, timings, jacobi_gap["f64"]


# A perturbed x0 whose covariance is indefinite: the cart's position and
# velocity get a covariance of 0.05 against their variances of 0.01, so the
# covariance's eigenvalues run from -0.04 to 0.06 while every variance stays
# positive. From it the first rollout steps' policy joints are indefinite,
# so the PSD boost (K5a in the whole-match path) acts.
INDEFINITE_X0_COV = np.zeros((4, 4))
INDEFINITE_X0_COV[0, 2] = INDEFINITE_X0_COV[2, 0] = 0.05


def initial_moments(loop, dtype, x0_shift=0.0, cov_extra=0.0):
    """The rollout's initial state moments: the episode spec's mean moved by
    ``x0_shift``, its covariance plus ``cov_extra``."""
    from gpflowpilco_torch.moments import GaussianMoments

    spec = loop.episode_spec
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=loop.device)[None]  # noqa: E731
    return GaussianMoments(mean=as_t(np.asarray(spec.state_mean) + x0_shift),
                           cov=as_t(spec.covariance() + cov_extra))


def policy_match_chain(loop, dtype, fused):
    """The loss's policy chain (squash after the deterministic SVGP policy
    match) in ``dtype``, through K3 when ``fused``."""
    from gpflowpilco_torch.loops.pilco import _cast_module
    from gpflowpilco_torch.moment_matching.gp import SVGPTransform
    from gpflowpilco_torch.moment_matching.rules import SquashedProbit
    from gpflowpilco_torch.moments import Chain

    return Chain(SquashedProbit(scale=2.0 * loop.policy_spec.action_scale - 1e-5), SVGPTransform(
        _cast_module(loop.policy_model, dtype), deterministic=True, fused_match=fused).with_cache())


def policy_joints(loop, x0, states, dtype):
    """The symmetrized policy joint (encoded state, action) of each rollout
    step before the PSD guard, taken at the step's input: x0, then the state
    after each earlier step. Stacked (T, D, D)."""
    from gpflowpilco_torch.moments import GaussianMoments

    pol = policy_match_chain(loop, dtype, fused=False)
    inputs = [x0] + [GaussianMoments(mean=states.mean[t], cov=states.cov[t])
                     for t in range(states.mean.shape[0] - 1)]
    joints = [pol.moment_match(loop.encoder.moment_match(xm).y).joint().cov for xm in inputs]
    return torch.cat([0.5 * (j + j.mT) for j in joints])


def whole_match_loss(loop, fused, dtype, x0_shift=0.0, cov_extra=0.0):
    """The 30-step MM loss of the loop's policy under its drift, everything
    (loss, drift, policy chain) in ``dtype``, from initial_moments. ``fused``
    takes every whole-match kernel op from the module-level options (frozen
    drift match, policy match, fused encoder, PSD guard, Euler update), not
    through the loop's gate; otherwise the unfused path. Returns (loss, the
    rollout's states)."""
    from gpflowpilco_torch.dynamics.forward import forward_moments
    from gpflowpilco_torch.dynamics.solvers import moment_matching_euler_rollout
    from gpflowpilco_torch.loops.pilco import _cast_module
    from gpflowpilco_torch.moment_matching.gp import SVGPTransform
    from gpflowpilco_torch.moments import GaussianMoments

    drift = SVGPTransform(_cast_module(loop.drift_model, dtype), fused_match=fused,
                          frozen=fused).with_cache()
    pol = policy_match_chain(loop, dtype, fused)
    enc = loop.encoder.with_fused(fused)
    _, means, covs = moment_matching_euler_rollout(
        lambda t, xm: forward_moments(xm, drift, policy=pol, encoder=enc, fused_glue=fused),
        initial_moments(loop, dtype, x0_shift, cov_extra), dt=1.0,
        num_steps=loop.episode_spec.num_steps, fused_update=fused,
    )
    states = GaussianMoments(mean=means, cov=covs)
    return loop.objective(enc.moment_match(states).y).sum(), states


def _flat_grads(model):
    return torch.cat([p.grad.reshape(-1).double() for p in model.parameters()
                      if p.requires_grad and p.grad is not None])


def match_slice_phase(counters, seed, device, step_limit, lbfgs_iters, jacobi_gap):
    """8 random episodes, then one full-width MM PILCO iteration on the
    whole-match path (use_fused_match, float32 loop and loss)."""
    from run_torch import build_loop

    from gpflowpilco_torch.dynamics.forward import forward_moments
    from gpflowpilco_torch.loops.driver import outer_loop
    from gpflowpilco_torch.loops.pilco import DriftSpec, MomentMatchingPILCO, PolicySpec, _cast_module
    from gpflowpilco_torch.moment_matching.gp import SVGPTransform
    from gpflowpilco_torch.moments import GaussianMoments
    from gpflowpilco_torch.ops import mm_glue_cuda as gc

    loop = build_loop(
        seed, device, torch.float32,
        drift_spec=DriftSpec(num_centers=M, max_iters=lbfgs_iters),
        policy_spec=PolicySpec(num_restarts=1, step_limit=step_limit),
        loop_cls=MomentMatchingPILCO,
    )
    loop.use_fused_match = True
    assert loop._fused_match_on and loop.episode_spec.num_steps == HORIZON_STEPS
    t0 = time.perf_counter()
    outer_loop(loop, num_episodes=8, num_episodes_init=8, log_summaries=False)
    sync()
    print(f"match slice: 8 random episodes in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    info_d = loop.update_dynamics()
    sync()
    t_dyn = time.perf_counter() - t0
    print(f"match slice: drift fit {1e3 * t_dyn:.1f} ms, loss {info_d['loss']:.4f}, "
          f"{info_d['iters']} iterations, M={loop.drift_model.num_inducing}; Adam "
          f"step_limit={step_limit}, horizon={HORIZON_STEPS}, float32 loop and loss")
    assert math.isfinite(info_d["loss"]) and loop.drift_model.num_inducing == M

    # ---- the main path: counts zeroed just before, read just after
    loop.policy_model = loop.build_policy()
    assert loop.policy_model.num_inducing == 30
    before = {n: p.detach().clone() for n, p in loop.policy_model.named_parameters()}
    for c in counters:
        c.reset_launches()
    t0 = time.perf_counter()
    info_p = loop.update_policy()
    sync()
    t_pol = time.perf_counter() - t0
    delta = {k: v for c in counters for k, v in c.launches.items()}
    print(f"match slice: policy update {1e3 * t_pol:.1f} ms = {1e3 * t_pol / step_limit:.2f} ms "
          f"per whole-match policy step; loss {info_p['loss']:.6f}, skipped "
          f"{info_p['skipped_steps']}; launches {delta}")
    assert math.isfinite(info_p["loss"]), "whole-match policy loss is not finite"
    # per Adam step: K3 forward for the drift and the policy at each of the
    # 30 rollout steps, their frozen and full backwards; K4 forward at each
    # step and once (N=30) on the post-rollout cost, and backward at steps
    # 2-30 and on the cost (the first step's match reads the constant x0, so
    # autograd records no backward for it); K5a and K5b at each step
    per_step = {"svgp_match_fwd_f32": 2 * HORIZON_STEPS, "svgp_match_bwd_frozen_f32": HORIZON_STEPS,
                "svgp_match_bwd_f32": HORIZON_STEPS, "enc_match_fwd_f32": HORIZON_STEPS + 1,
                "enc_match_bwd_f32": HORIZON_STEPS, "psd_boost_f32": HORIZON_STEPS,
                "euler_update_f32": HORIZON_STEPS}
    want = {k: per_step.get(k, 0) * step_limit for k in delta}
    assert delta == want, f"launches {delta}, expected {want}"
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in loop.policy_model.named_parameters() if p.requires_grad)
    assert moved > 0, "policy parameters did not change"

    t0 = time.perf_counter()
    ep = loop.step()
    sync()
    t_ep = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.launches.items()}
    # the episode's eReward metric evaluates the loss once, forward only
    fwd_only = ("svgp_match_fwd_f32", "enc_match_fwd_f32", "psd_boost_f32", "euler_update_f32")
    want = {k: v + (per_step[k] if k in fwd_only else 0) for k, v in delta.items()}
    assert launches == want, f"launches after the episode {launches}, expected {want}"
    print(f"match slice: RK4 episode {1e3 * t_ep:.1f} ms, reward {ep.metrics['rewards']:.4f}, "
          f"model-predicted {ep.metrics.get('eReward', float('nan')):.4f}")
    assert ep.states.shape == (HORIZON_STEPS + 1, 4) and np.isfinite(ep.states).all()

    # ---- output check, float64: the 30-step loss at the trained policy with
    # every whole-match kernel against the unfused path, from the episode's
    # x0 and from x0 with an indefinite covariance (INDEFINITE_X0_COV). The
    # episode's x0 gives PSD policy joints; the other makes the first steps'
    # joints indefinite, so K5a's boost acts inside the composition, by
    # Jacobi's lambda_min where the unfused guard takes eigvalsh's; it must
    # act at one step at least. Each run's bar: max(1e-9, 10x the unfused
    # loss's rounding noise from that x0, 10x the Jacobi-vs-eigvalsh
    # lambda_min gap relative to the joint's scale, at both runs' policy
    # joints before the guard and at the kernel phase's indefinite ones)
    f64 = torch.float64
    runs, joints = {}, []
    with torch.no_grad():
        for label, extra in (("episode x0", 0.0), ("x0 with an indefinite covariance", INDEFINITE_X0_COV)):
            l_fused, states = whole_match_loss(loop, True, f64, cov_extra=extra)
            l_unfused = float(whole_match_loss(loop, False, f64, cov_extra=extra)[0])
            noise = max(abs(float(whole_match_loss(loop, False, f64, dx, extra)[0]) - l_unfused)
                        / abs(l_unfused) for dx in (1e-14, 1e-13, 1e-12))
            sym = policy_joints(loop, initial_moments(loop, f64, cov_extra=extra), states, f64)
            active = int((torch.linalg.eigvalsh(sym).amin(-1) < 0).sum())
            joints.append(sym)
            runs[label] = (float(l_fused), l_unfused, noise, active)
            if label == "episode x0":
                nominal = states  # the float32 step check below starts from its states
        sym = torch.cat(joints)
        lam_j, lam_e = gc.jacobi_min_eig(sym), torch.linalg.eigvalsh(sym).amin(-1)
        gap = max(jacobi_gap, float(((lam_j - lam_e).abs() / (1.0 + sym.abs().amax(dim=(-2, -1)))).max()))
    print(f"match slice: 30-step float64 loss, whole-match kernels vs unfused; Jacobi vs eigvalsh "
          f"lambda_min gap {gap:.3e} (scaled; {sym.shape[0]} policy joints before the guard and the "
          f"kernel phase's indefinite ones)")
    for label, (l_fused, l_unfused, noise, active) in runs.items():
        rel = abs(l_fused - l_unfused) / abs(l_unfused)
        bar = max(1e-9, 10.0 * noise, 10.0 * gap)
        print(f"  {label}: whole-match kernels {l_fused:.15f}, unfused {l_unfused:.15f}, relative gap "
              f"{rel:.3e}; unfused rounding noise {noise:.3e}, bar {bar:.3e}; the boost active at "
              f"{active} of {HORIZON_STEPS} steps")
        assert math.isfinite(l_fused) and rel <= bar, "whole-match and unfused float64 losses disagree"
    assert runs["x0 with an indefinite covariance"][3] > 0, "K5a's boost never acted in the float64 check"

    # ---- output check, float32: one forward_moments step at a state of that
    # rollout, through every whole-match op and unfused, both held against
    # the float64 unfused step; bar: the fused step may miss it by 3x what
    # the unfused float32 step does plus 1e-4 of each output's scale
    k = HORIZON_STEPS // 3
    outs = {}
    for name, fused, dtype in (("fused", True, torch.float32), ("unfused", False, torch.float32),
                               ("truth", False, f64)):
        drift = SVGPTransform(_cast_module(loop.drift_model, dtype), fused_match=fused,
                              frozen=fused).with_cache()
        pol = policy_match_chain(loop, dtype, fused)
        xm = GaussianMoments(mean=nominal.mean[k].to(dtype), cov=nominal.cov[k].to(dtype))
        with torch.no_grad():
            mt = forward_moments(xm, drift, policy=pol, encoder=loop.encoder.with_fused(fused),
                                 fused_glue=fused)
        outs[name] = (mt.y.mean, mt.y.cov, mt.cross_covariance(preinv=False))
    for what, a, b, c in zip(("mean", "cov", "cross"), outs["fused"], outs["unfused"], outs["truth"]):
        err_f, err_u = scaled_err(a, c), scaled_err(b, c)
        print(f"match slice: float32 step {k} {what}: fused {err_f:.3e}, unfused {err_u:.3e} "
              f"(scaled, vs float64)")
        assert torch.isfinite(a).all() and err_f <= 3.0 * err_u + 1e-4, f"float32 step {what} disagrees"

    # ---- printed, not asserted: the 30-step float32 losses and the cosine
    # of the float32 whole-match policy gradient against the float64 truth
    # (a 30-step float32 rollout at a fitted drift is chaotic)
    grads, losses = {}, {}
    for name, fused, dtype in (("whole-match f32", True, torch.float32),
                               ("unfused f32", False, torch.float32), ("unfused f64", False, f64)):
        loop.policy_model.zero_grad(set_to_none=True)
        loss = whole_match_loss(loop, fused, dtype)[0]
        loss.backward()
        losses[name], grads[name] = float(loss.detach()), _flat_grads(loop.policy_model)
    truth = grads["unfused f64"]
    cos = {n: float(g @ truth / (g.norm() * truth.norm())) for n, g in grads.items() if n != "unfused f64"}
    print(f"match slice: 30-step losses {json.dumps(losses)}; gradient cosine vs float64 "
          f"{json.dumps(cos)}")
    return loop, launches, dict(dynamics_ms=1e3 * t_dyn, policy_step_ms=1e3 * t_pol / step_limit,
                                episode_ms=1e3 * t_ep)


# ---------------------------------------------------------------- slice B
# The HMC-ensemble path's shapes: K=8 members of a GPR drift on N=240
# transitions (8 random episodes), D=6 inputs (5 features and the action),
# R=4 outputs; K3g on one moment set per member, K2's GPR route with the
# members on its pair axis and R=4 rows of alpha^T
GPR_K, GPR_N, GPR_R = 8, M, 4
HMC_CUT = dict(hmc_chains=8, hmc_warmup=50, hmc_samples=50, hmc_leapfrog=16, hmc_ensemble=GPR_K)
PW_STEPS = 20  # Adam steps of the pathwise ensemble policy update (c)
# the random model's noise, that of the HMC ensemble's members on this
# deterministic simulator (2e-5 to 3e-5 in the ensemble slice): Kyy^-1 is
# then large, and var - sum(Kyy^-1 o E) cancels digits in float32
GPR_NOISE = 2e-5


def gpr_model(k, n, d, r, device, seed, noise=GPR_NOISE):
    """A float64 GPR stacked over k members on random data, with numpy-drawn
    hyperparameters (lengthscales 1-2, noise around ``noise``)."""
    from gpflowpilco_torch.models.gp import GPR
    from gpflowpilco_torch.models.kernels import RBF
    from gpflowpilco_torch.utils import bijectors as bij

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    x = 1.5 * rng.normal(size=(n, d))
    y = np.sin(x[:, :r] + x[:, -1:]) + 0.1 * rng.normal(size=(n, r))
    return GPR(RBF.create(f(rng.uniform(0.5, 1.5, size=k)), f(rng.uniform(1.0, 2.0, size=(k, d)))),
               f(x), f(y), f(0.1 * rng.normal(size=(k, r))),
               bij.positive_inv(f(noise * rng.uniform(0.5, 2.0, size=k)))).requires_grad_(False)


def gpr_match_grids(model, dtype):
    """The K3g grid of ``model`` in ``dtype`` and in float64."""
    from gpflowpilco_torch.moment_matching.gp import gpr_match_cache
    from gpflowpilco_torch.ops import gpr_match_cuda as gm

    with torch.no_grad():
        c = gpr_match_cache(model)
        g64 = gm.build_fused_gpr_match_grid(model, c.alpha, c.kyy_inv)
    cast = {f: v.to(dtype).contiguous() for f, v in zip(gm.GPR_GRID_FIELDS, g64.tensors())}
    return gm.FusedGPRMatchGrid(**cast, meta=g64.meta), g64


def gpr_well_conditioned(g, rng):
    """The grid ``g`` with O(1) representer weights and a symmetric Kyy^-1 of
    entries ~1/N (cf. well_conditioned for K3)."""
    from gpflowpilco_torch.ops import gpr_match_cuda as gm

    t = dict(zip(gm.GPR_GRID_FIELDS, g.tensors()))
    like = lambda a: torch.as_tensor(a, dtype=g.alpha.dtype, device=g.alpha.device)  # noqa: E731
    q = like(rng.normal(size=tuple(g.kyy_inv.shape))) / g.meta.num_n
    t.update(alpha=like(rng.normal(size=tuple(g.alpha.shape))), kyy_inv=(0.5 * (q + q.mT)).contiguous())
    return gm.FusedGPRMatchGrid(**t, meta=g.meta)


def gpr_match_bound_ms(kind, meta, b, dtype):
    """Least time of one K3g call: each input read once and each output
    written once, and its operations (an exp counts as one) (_bound). Each
    cell (i, j) of a member's E grid counts once: the exponent's two D-term
    dots, the exp and, in the forward, the R alpha products and the Kyy^-1
    product (4D + 2R + 5); in the backward, E, the two R-term dots, the
    Kyy^-1 term and the D-term sum of E s up_j (6D + 4R + 8). Each point's
    D-vector solves count once, though every block repeats them."""
    k, n, d, r = meta.num_members, meta.num_n, meta.num_dim, meta.num_out
    size = torch.finfo(dtype).bits // 8
    grid = d * n + k * (2 * d + n * r + 3 + n * n + 2 * d * n + n)
    io = b * k * (d + d * d)
    cells = b * k * n * n
    solves = b * k * n * (4 * d * d + 10 * d)  # eKfu's and the pair's per-point solves
    if kind == "fwd":
        outputs = b * k * (r + r * r + d * r)
        return _bound((grid + io + outputs) * size, solves + cells * (4 * d + 2 * r + 5), dtype)
    cots = b * k * (2 * r + r * r + d * r)
    return _bound((grid + 2 * io + cots) * size, 2 * solves + cells * (6 * d + 4 * r + 8), dtype)


def gpr_kernels_phase(gm, kc, seed, device):
    """Hold K3g (forward, frozen backward) and K2's GPR route (forward and
    frozen backward, R=4 rows, the 8 members on the pair axis) against their
    plain versions in float32 and float64 at N=240, D=6, R=4, K=8, and time
    each beside its plain version and its bound.

    Bars: K3g float64, MATCH_F64_TOL of each output's scale; float32, with
    its plain version against float64 at a random model's grid (3x the
    plain version's error plus 1e-4 of the scale: at GPR_NOISE, Kyy^-1 is
    large and var - sum(Kyy^-1 o E) cancels digits), and against
    plain float32 at MATCH_WC_TOL of the scale on a well-conditioned grid of
    the same shape. K2's GPR route: PAIR_TOL (rtol = atol) on the operands
    of a model at noise 0.5, whose Kyy^-1 has O(1) entries like the random
    qm of K2's other checks, and in float64 also MATCH_F64_TOL of each
    output's scale at GPR_NOISE, where Kyy^-1 is large as on the main path."""
    from gpflowpilco_torch.moment_matching.gp import gpr_match_cache
    from gpflowpilco_torch.ops.kexp_cuda import build_fused_gpr_grid, gpr_pair_operands

    rng = np.random.default_rng(seed + 3000)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)
    errs = {name: 0.0 for name in (*gm.launches, *(f"{n}/gpr" for n in kc.launches))}
    timings, calls = {}, {}

    def record(name, got, want, what):
        err = float((got.double() - want.double()).abs().max())
        errs[name] = max(errs[name], err)
        scaled = scaled_err(got, want)
        print(f"  {name} {what}: max |kernel - plain| = {err:.3e}, scaled {scaled:.3e}")
        return scaled

    def k3g_outputs(g, mx, sxx, cots, kernel):
        if kernel:
            fwd = gm._fwd(g.meta, g, mx, sxx)
            return {"fwd": fwd, "bwd_frozen": gm._bwd(g.meta, g, mx, sxx, fwd[0], *cots)}
        return {"fwd": gm.gpr_match_reference(g.meta, g, mx, sxx),
                "bwd_frozen": gm.gpr_match_reference_bwd(g.meta, g, mx, sxx, *cots)}

    model = gpr_model(GPR_K, GPR_N, D, GPR_R, device, seed + 3001)
    names = {"fwd": ("f1", "sff", "cross"), "bwd_frozen": ("dmx", "dsxx")}
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        g, g64 = gpr_match_grids(model, dtype)
        mx, sxx = state_moments(rng, GPR_K, D, dtype, device)
        mx, sxx = mx[None].contiguous(), sxx[None].contiguous()
        f = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype, device=device)  # noqa: E731
        cots = (f(1, GPR_K, GPR_R), f(1, GPR_K, GPR_R, GPR_R), f(1, GPR_K, D, GPR_R))
        print(f"gpr match B=1 K={GPR_K} N={GPR_N} D={D} R={GPR_R} noise~{GPR_NOISE} {sfx}:")
        got = k3g_outputs(g, mx, sxx, cots, True)
        plain = k3g_outputs(g, mx, sxx, cots, False)
        truth = k3g_outputs(g64, mx.double(), sxx.double(), [c.double() for c in cots], False)
        sync()
        for kind, outs in names.items():
            name = f"gpr_match_{kind}_{sfx}"
            for what, a, b, c in zip(outs, got[kind], plain[kind], truth[kind]):
                err = record(name, a, b, what)
                ok = bool(torch.isfinite(a).all())
                if dtype == torch.float64:
                    ok = ok and err <= MATCH_F64_TOL
                else:
                    err_k, err_p = scaled_err(a, c), scaled_err(b, c)
                    print(f"    vs float64: kernel {err_k:.3e}, plain float32 {err_p:.3e}")
                    ok = ok and err_k <= 3.0 * err_p + 1e-4
                if not ok:
                    raise AssertionError(f"{name} {what}: kernel disagrees with its plain version")
        for kind in names:
            runs = [k3g_outputs(g, mx, sxx, cots, True)[kind] for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"gpr_match_{kind}_{sfx}: repeated runs differ")
        print(f"  gpr_match_fwd_{sfx}, gpr_match_bwd_frozen_{sfx}: repeated runs bit-identical")
        if dtype == torch.float32:
            wc = gpr_well_conditioned(g, rng)
            mxw, sxxw = state_moments(rng, GPR_K, D, dtype, device, shift=WC_STATE_SHIFT)
            mxw, sxxw = mxw[None].contiguous(), sxxw[None].contiguous()
            got_w = k3g_outputs(wc, mxw, sxxw, cots, True)
            plain_w = k3g_outputs(wc, mxw, sxxw, cots, False)
            sync()
            print(f"  well-conditioned grid, bar {MATCH_WC_TOL:g} of the scale:")
            for kind, outs in names.items():
                for what, a, b in zip(outs, got_w[kind], plain_w[kind]):
                    if not (torch.isfinite(a).all()
                            and record(f"gpr_match_{kind}_{sfx}", a, b, what) <= MATCH_WC_TOL):
                        raise AssertionError(f"gpr_match_{kind}_{sfx} {what}: kernel disagrees on "
                                             f"the well-conditioned grid")
        args = (g.meta, g, mx, sxx)
        calls[f"gpr_match_fwd_{sfx}"] = (
            lambda a=args: gm._fwd(*a), lambda a=args: gm.gpr_match_reference(*a),
            gpr_match_bound_ms("fwd", g.meta, 1, dtype))
        calls[f"gpr_match_bwd_frozen_{sfx}"] = (
            lambda a=args, c=cots, f1=got["fwd"][0]: gm._bwd(*a, f1, *c),
            lambda a=args, c=cots: gm.gpr_match_reference_bwd(*a, *c),
            gpr_match_bound_ms("bwd_frozen", g.meta, 1, dtype))

        def k2_pairs(gmodel):
            """(operands, ((fwd, outputs, kernel's, plain's), (bwd_frozen,
            ...))) of K2's GPR route on ``gmodel``'s operands at these
            moments."""
            with torch.no_grad():
                c = gpr_match_cache(gmodel)
                grid = build_fused_gpr_grid(gmodel.kernel.variance, gmodel.kernel.lengthscales,
                                            gmodel.x, c.alpha, c.kyy_inv)
                su, sw, _ = gpr_pair_operands(grid, mx, sxx)
            ops = (su.contiguous(), sw.contiguous(), grid.alphat, grid.qm)
            want_f = kc.pair_contract_reference(*ops)
            want_b = kc.pair_contract_reference_bwd(*ops, *cot, False)
            got_f, got_b = kc._fwd(*ops), kc._bwd(*ops, *cot, False)
            sync()
            return ops, (("fwd", ("evc", "qcol"), got_f, want_f),
                         ("bwd_frozen", ("dsu", "dsw"), got_b[:2], want_b[:2]))

        # K2's GPR route, on the operands of a model at noise 0.5
        wmodel = gpr_model(GPR_K, GPR_N, D, GPR_R, device, seed + 3002, noise=0.5).to(dtype)
        cot = (f(1, GPR_K, GPR_R, GPR_N), f(1, GPR_K, GPR_N))
        ops, pairs = k2_pairs(wmodel)
        d2 = ops[0].shape[2]
        tol = PAIR_TOL[dtype]
        print(f"pair contract, GPR route N=1 P={GPR_K} D2={d2} M={GPR_N} R={GPR_R} {sfx}, "
              f"rtol=atol={tol}:")
        for kind, outs, gots, wants in pairs:
            name = f"pair_contract_{kind}_{sfx}/gpr"
            for what, a, b in zip(outs, gots, wants):
                errs[name] = max(errs[name], check(f"{name} {what}", a, b, tol))
        pair_repeats(kc, ops, cot, sfx, "/gpr")
        if dtype == torch.float64:
            # and on the main path's conditioning: the noise~GPR_NOISE model,
            # whose Kyy^-1 (qm) and alpha are large, at K3g's float64 bar
            print(f"pair contract, GPR route {sfx} at noise~{GPR_NOISE}, bar {MATCH_F64_TOL:g} of the "
                  f"scale:")
            for kind, outs, gots, wants in k2_pairs(model)[1]:
                name = f"pair_contract_{kind}_{sfx}/gpr"
                for what, a, b in zip(outs, gots, wants):
                    if not (torch.isfinite(a).all() and record(name, a, b, what) <= MATCH_F64_TOL):
                        raise AssertionError(f"{name} {what}: kernel disagrees with its plain version "
                                             f"at noise~{GPR_NOISE}")
        calls[f"pair_contract_fwd_{sfx}/gpr"] = (
            lambda o=ops: kc._fwd(*o), lambda o=ops: kc.pair_contract_reference(*o),
            pair_bound_ms("fwd", 1, GPR_K, d2, GPR_N, dtype, r=GPR_R))
        calls[f"pair_contract_bwd_frozen_{sfx}/gpr"] = (
            lambda o=ops, c=cot: kc._bwd(*o, *c, False),
            lambda o=ops, c=cot: kc.pair_contract_reference_bwd(*o, *c, False),
            pair_bound_ms("bwd_frozen", 1, GPR_K, d2, GPR_N, dtype, r=GPR_R))

    for name, (kern, plain, (bound, bound_by)) in calls.items():
        ms = median_ms(kern, flush=flush)
        warm_ms = median_ms(kern)
        plain_ms, plain_how = plain_ms_of(plain, flush)
        timings[name] = dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms, plain_how=plain_how,
                             bound_ms=bound, bound_by=bound_by, library_ms=None)
        print(f"  {name}: {ms:.4f} ms cold-L2 median ({warm_ms:.4f} ms warm), plain torch "
              f"{plain_ms:.4f} ms ({plain_how}), bound {bound:.6f} ms ({bound_by})")
    # the stages (warm L2) of K3g's entries (the forward's tiles and combine,
    # the frozen backward's tile sweep, finish and combine) and of K2's GPR
    # route (tiles, finish)
    for name in ("gpr_match_fwd_f32", "gpr_match_fwd_f64", "gpr_match_bwd_frozen_f32", "gpr_match_bwd_frozen_f64",
                 "pair_contract_fwd_f64/gpr", "pair_contract_bwd_frozen_f64/gpr"):
        stages = stage_ms(calls[name][0])
        timings[name]["stages"] = stages
        print(f"  stages of {name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items()))
    return errs, timings


def syncs_per_leapfrog(loop, ens):
    """Host synchronizations of one leapfrog step's batched LML+gradient
    evaluation (the HMC target of _hmc_gpr_ensemble, in the loop's dtype) at
    states the chains visited: the ensemble's members, one draw from each
    chain. Counted by torch's sync debug mode: (count, the Python lines that
    synchronized, the factorizations of the batch's Kyy, i.e. one plus the
    jitter-escalation levels that ran)."""
    import warnings

    from gpflowpilco_torch.loops.pilco import gpr_log_posterior
    from gpflowpilco_torch.models.hmc import _logp_and_grad

    members = ens.members
    q = torch.cat([p.detach().reshape(ens.num_members, -1) for p in members.parameters()], dim=1)
    log_prob = gpr_log_posterior(loop.build_dynamics(), loop.drift_spec)  # the same data
    _logp_and_grad(log_prob, q)  # warm-up
    sync()
    cholesky_ex, factorizations = torch.linalg.cholesky_ex, []

    def counted(*a, **kw):
        factorizations.append(a[0].shape)
        return cholesky_ex(*a, **kw)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        torch.linalg.cholesky_ex = counted
        try:
            _logp_and_grad(log_prob, q)
        finally:
            torch.linalg.cholesky_ex = cholesky_ex
            torch.cuda.set_sync_debug_mode(0)
    where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    return len(where), where, len(factorizations)


def ensemble_slice_phase(counters, seed, device, step_limit, lbfgs_iters):
    """8 random episodes, a GPR L-BFGS fit and HMC (8 chains, HMC_CUT),
    thinned to an 8-member ensemble; then (a) a whole-match ensemble MM
    policy update in float32, (b) one float64 loss+grad through the
    pair-grid kernel, held against the unfused float64 loss, (c) one
    pathwise ensemble loss+grad and a short pathwise policy update, and (d)
    that update with use_fused_rollout, then the float64 loss and gradient
    through K6 against the per-step GPR path (f64_rollout_hold)."""
    from run_torch import build_loop

    from gpflowpilco_torch.loops.driver import outer_loop
    from gpflowpilco_torch.loops.pilco import DriftSpec, MomentMatchingPILCO, PathwisePILCO, PolicySpec
    from gpflowpilco_torch.models.gp import GPREnsemble
    from gpflowpilco_torch.models.pathwise import PathState, generate_paths_gpr
    from gpflowpilco_torch.ops import kexp_cuda as kc

    def counts():
        return {k: v for c in counters for k, v in c.launches.items()}

    def reset():
        for c in counters:
            c.reset_launches()

    drift_spec = DriftSpec(model_type="gpr", optimizer="hmc", max_iters=lbfgs_iters, **HMC_CUT)
    loop = build_loop(seed, device, torch.float32, drift_spec=drift_spec,
                      policy_spec=PolicySpec(num_restarts=1, step_limit=step_limit),
                      loop_cls=MomentMatchingPILCO)
    loop.use_fused_match = True
    outer_loop(loop, num_episodes=8, num_episodes_init=8, log_summaries=False)
    sync()
    reset()
    t0 = time.perf_counter()
    info_d = loop.update_dynamics()
    sync()
    t_dyn = time.perf_counter() - t0
    ens = loop.drift_model
    assert isinstance(ens, GPREnsemble) and ens.num_members == GPR_K
    assert ens.members.x.shape == (GPR_N, D) and ens.members.y.shape == (GPR_N, GPR_R)
    noise = ens.members.noise_variance.detach().cpu().numpy()
    print(f"ensemble slice: GPR L-BFGS fit (max {lbfgs_iters} iterations, {info_d['iters']} run, loss "
          f"{info_d['loss']:.4f}) and HMC {HMC_CUT} in {1e3 * t_dyn:.1f} ms, of which HMC "
          f"{1e3 * info_d['hmc_seconds']:.1f} ms; acceptance {info_d['hmc_accept']:.3f}, step size "
          f"{info_d['hmc_step_size']:.4f}; member noise {np.array2string(noise, precision=6)}")
    assert math.isfinite(info_d["loss"]) and 0.0 < info_d["hmc_accept"] <= 1.0
    assert not any(counts().values()), f"the drift fit launched kernels: {counts()}"
    syncs, where, facts = syncs_per_leapfrog(loop, ens)
    print(f"ensemble slice: host synchronizations per leapfrog step ({HMC_CUT['hmc_chains']} chains, at "
          f"the members' states, {loop.dtype}): {syncs}, at {where}; Kyy factorizations {facts} "
          f"(jitter escalation levels run: {facts - 1})")

    # ---- (a) whole-match ensemble MM policy update, float32: counts zeroed
    # just before, read just after
    loop.policy_model = loop.build_policy()
    before = {n: p.detach().clone() for n, p in loop.policy_model.named_parameters()}
    reset()
    t0 = time.perf_counter()
    info_p = loop.update_policy()
    sync()
    t_a = time.perf_counter() - t0
    delta = counts()
    print(f"ensemble slice (a): whole-match policy update {1e3 * t_a:.1f} ms = "
          f"{1e3 * t_a / step_limit:.2f} ms per ensemble MM policy step; loss {info_p['loss']:.6f}, "
          f"skipped {info_p['skipped_steps']}; launches {delta}")
    assert math.isfinite(info_p["loss"]), "ensemble whole-match loss is not finite"
    # per Adam step: one K3g forward and one frozen backward per rollout step
    # for all 8 members; the policy's K3 forward and full backward, K4, K5a
    # and K5b as in the whole-match slice (the drift's K3 is now K3g)
    per_step = {"gpr_match_fwd_f32": HORIZON_STEPS, "gpr_match_bwd_frozen_f32": HORIZON_STEPS,
                "svgp_match_fwd_f32": HORIZON_STEPS, "svgp_match_bwd_f32": HORIZON_STEPS,
                "enc_match_fwd_f32": HORIZON_STEPS + 1, "enc_match_bwd_f32": HORIZON_STEPS,
                "psd_boost_f32": HORIZON_STEPS, "euler_update_f32": HORIZON_STEPS}
    want = {k: per_step.get(k, 0) * step_limit for k in delta}
    assert delta == want, f"launches {delta}, expected {want}"
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in loop.policy_model.named_parameters() if p.requires_grad)
    assert moved > 0, "policy parameters did not change"
    launches_a = dict(delta)
    t0 = time.perf_counter()
    ep = loop.step()
    sync()
    t_ep = time.perf_counter() - t0
    print(f"ensemble slice (a): RK4 episode {1e3 * t_ep:.1f} ms, reward {ep.metrics['rewards']:.4f}, "
          f"model-predicted {ep.metrics.get('eReward', float('nan')):.4f}")
    assert np.isfinite(ep.states).all() and math.isfinite(ep.metrics["eReward"])

    # ---- (b) use_fused_mm, float64 loss with the float32 policy island: one
    # timed loss+grad, counts zeroed just before and read just after
    loop.use_fused_match, loop.use_fused_mm = False, True
    loop.policy_spec = dataclasses.replace(loop.policy_spec, loss_dtype=torch.float64)
    model = loop.policy_model
    model.zero_grad(set_to_none=True)
    reset()
    t0 = time.perf_counter()
    loss = loop.policy_loss_fn(model, None, drift=loop.policy_loss_drift())
    loss.backward()
    sync()
    t_b = time.perf_counter() - t0
    delta = counts()
    want = dict.fromkeys(delta, 0)
    for name in ("pair_contract_fwd_f64", "pair_contract_bwd_frozen_f64",
                 "pair_contract_fwd_f32", "pair_contract_bwd_f32"):
        want[name] = HORIZON_STEPS
    print(f"ensemble slice (b): float64 pair-grid ensemble loss+grad {1e3 * t_b:.1f} ms, loss "
          f"{float(loss.detach()):.9f}; launches {delta}")
    assert delta == want, f"launches {delta}, expected {want}"
    launches_b = dict(delta)
    losses = mm_losses(loop)
    # the same pair-grid formulation with K2's plain version in the kernel's
    # place: it isolates the kernel from the formulation (an explicit Kyy^-1
    # against the unfused path's Cholesky solves)
    fwd = kc._fwd
    kc._fwd = kc.pair_contract_reference
    try:
        losses.update(mm_losses(loop, paths=(("plain", True),)))
    finally:
        kc._fwd = fwd
    gap = lambda a, b: abs(losses[a] - losses[b]) / abs(losses[b])  # noqa: E731
    # the ensemble's members have noise ~2e-5, so Kyy^-1 is large and the
    # float64 loss's rounding noise is too (~1e-6)
    noise_rel = mm_loss_noise(loop, losses["unfused"])
    bar = max(1e-9, 10.0 * noise_rel)
    print(f"ensemble slice (b): 30-step float64 ensemble MM loss via the kernel {losses['kernel']:.15f}, "
          f"via K2's plain version {losses['plain']:.15f}, unfused {losses['unfused']:.15f}; relative "
          f"gaps kernel-plain {gap('kernel', 'plain'):.3e}, kernel-unfused {gap('kernel', 'unfused'):.3e}, "
          f"plain-unfused {gap('plain', 'unfused'):.3e}; rounding noise {noise_rel:.3e}, bar {bar:.3e}")
    assert math.isfinite(losses["kernel"]) and gap("kernel", "plain") <= bar, \
        "the ensemble MM loss through the kernel and through its plain version disagree"
    assert gap("kernel", "unfused") <= bar, "fused and unfused ensemble MM losses disagree"

    # ---- (c) pathwise ensemble: 1024 particles over the 8 members, 1024 bases
    pw = build_loop(seed, device, torch.float32, drift_spec=drift_spec,
                    policy_spec=PolicySpec(batch_size=S, num_bases=B, num_restarts=1, step_limit=PW_STEPS),
                    loop_cls=PathwisePILCO)
    pw.episodes, pw.drift_model = list(loop.episodes), ens
    pw.policy_model = pw.build_policy()
    reset()
    t0 = time.perf_counter()
    pw_loss = pw.policy_loss_fn(pw.policy_model, pw.iteration_generator(98))
    pw_loss.backward()
    sync()
    t_c1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    info_c = pw.update_policy()
    sync()
    t_c = time.perf_counter() - t0
    delta = counts()
    print(f"ensemble slice (c): pathwise ensemble loss+grad {1e3 * t_c1:.1f} ms (loss "
          f"{float(pw_loss.detach()):.6f}); {PW_STEPS}-step policy update {1e3 * t_c:.1f} ms = "
          f"{1e3 * t_c / PW_STEPS:.2f} ms per pathwise ensemble step, loss {info_c['loss']:.6f}")
    assert math.isfinite(float(pw_loss.detach())) and math.isfinite(info_c["loss"])
    assert not any(delta.values()), f"the GPR paths run in plain torch, yet kernels ran: {delta}"

    # ---- (d) the same update with use_fused_rollout: one K6 forward and one
    # backward per step for all 8 members
    pw.use_fused_rollout = True
    assert pw._fused_rollout_eligible(ens.members, pw.policy_model)
    reset()
    cap = graph_captures()
    t0 = time.perf_counter()
    info_d2 = pw.update_policy()
    sync()
    t_d = time.perf_counter() - t0
    delta = counts()
    print(f"ensemble slice (d): fused-rollout {PW_STEPS}-step policy update {1e3 * t_d:.1f} ms = "
          f"{1e3 * t_d / PW_STEPS:.2f} ms per fused pathwise ensemble step, loss {info_d2['loss']:.6f}; "
          f"launches {delta}")
    want = dict.fromkeys(delta, 0)
    cap = graph_captures() - cap
    want.update(rollout_fwd_f32=PW_STEPS + cap, rollout_bwd_f32=PW_STEPS + cap)
    assert math.isfinite(info_d2["loss"]) and delta == want, f"launches {delta}, expected {want}"
    # at that state, float64: K6 with the 8 members on its member axis
    # against the per-step GPR path at the same paths and x0 (drawn once in
    # float32 and cast)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    per = S // GPR_K
    with torch.no_grad():
        paths = generate_paths_gpr(ens.members, gen, per, B)
        x0 = pw.episode_spec.sample(gen, (per * GPR_K,), dtype=torch.float32, device=device)
    pw64 = build_loop(seed, device, torch.float64, drift_spec=drift_spec, policy_spec=pw.policy_spec,
                      loop_cls=PathwisePILCO)
    pw64.use_fused_rollout = True
    rel_d, noise_d, cos_d, _ = f64_rollout_hold(
        "ensemble slice (d)", pw64, copy.deepcopy(pw.policy_model).double(),
        copy.deepcopy(pw.policy_loss_drift().members).double(), PathState(*(p.double() for p in paths)), x0.double())
    return loop, pw, launches_a, launches_b, dict(
        dynamics_ms=1e3 * t_dyn, hmc_ms=1e3 * info_d["hmc_seconds"], syncs_per_leapfrog=syncs,
        escalation_levels=facts - 1,
        hmc_accept=info_d["hmc_accept"], ensemble_mm_step_ms=1e3 * t_a / step_limit,
        fused_mm_f64_loss_grad_ms=1e3 * t_b, pathwise_loss_grad_ms=1e3 * t_c1,
        pathwise_step_ms=1e3 * t_c / PW_STEPS, fused_rollout_step_ms=1e3 * t_d / PW_STEPS,
        fused_rollout_f64_rel_gap=rel_d, fused_rollout_f64_noise=noise_d, fused_rollout_f64_grad_cos=cos_d)


# ---------------------------------------------------------------- K6
# The whole-rollout kernel at the pathwise slice's widths: S=1024 particles,
# Ld=4 drift latents over Dxu=6 inputs (5 features and the action), B=1024
# bases, M=240 centers, Mp=30 policy centers, 30 steps
ROLL_F64_TOL = 1e-10  # of each output's scale: the same sums in another order
ROLL_F32_TOL = 1e-4  # of each output's scale over ROLL_SHORT_T steps, where the rollout is healthy
ROLL_SHORT_T = 5
ROLL_MEMBERS = 8  # the HMC ensemble's members on K6's member axis
ROLL_WIDTHS = dict(s=S, lp=1, ld=L, u=1, steps=HORIZON_STEPS, b=B, m=M, mp=30, active=(1,), action_scale=10.0)


def rollout_operands(rc, k, s, lp, ld, u, steps, dtype, device, seed, b=B, m=M, mp=30, active=(1,),
                     action_scale=10.0):
    """A K6 meta and operands (x0 first) from numpy, D=4 with the encoder's
    ``active`` dims (the cartpole's (1,) or the double pendulum's (0, 1)),
    x0 near pi on those: lengthscales 1-2, path weights small enough that
    30 steps stay in a healthy state, a non-symmetric precision matrix.
    Made in float64 and cast."""
    rng = np.random.default_rng(seed)
    n = lambda *sh: rng.normal(size=sh)  # noqa: E731
    d = 4
    de = d + len(active)
    dxu = de + u
    meta = rc.RolloutMeta(num_steps=steps, dt=1.0, squash_scale=2.0 * action_scale - 1e-5,
                          active_dims=active, state_dim=d, enc_dim=de, act_dim=u, num_latent=ld,
                          pol_latent=lp)
    ls_p, ls_d = rng.uniform(0.7, 1.5, size=(lp, de)), rng.uniform(1.0, 2.0, size=(k, ld, dxu))
    zp, zd, a = n(lp, mp, de), n(k, ld, m, dxu), n(de, de)
    x0 = math.pi * np.isin(np.arange(d), active) + 0.1 * n(s, d)
    ops = (x0, zp, (zp * zp).sum(-1), 0.3 * n(lp, mp), 1.0 / ls_p, n(u, lp), 0.1 * n(u),
           n(k, ld, b, dxu) / ls_d[:, :, None, :], rng.uniform(0, 2 * math.pi, size=(k, ld, b)),
           1.0 / ls_d, zd, (zd * zd).sum(-1), 0.1 * n(s, ld, b) * math.sqrt(2.0 / b),
           0.01 * n(s, ld, m), 0.5 * n(d, ld), 0.01 * n(k, d), n(de),
           0.1 * a @ a.T + np.eye(de) + 0.02 * n(de, de))
    return meta, tuple(torch.as_tensor(o, dtype=dtype, device=device).contiguous() for o in ops)


def rollout_bound_ms(kind, meta, ops, dtype):
    """Least time of one K6 launch: each input read once and each output
    written once, and the operations each pass needs (a cos, sin or exp
    counts as one, an FMA as two) (_bound). Per particle and step the
    forward evaluates the policy and the drift's centers (per center the
    dot with the pre-scaled center, the distance from the per-particle
    |x|^2 and the pre-computed |z|^2, the exp and the weight: 2 Dxu + 8) and
    bases (the projection, the phase, the cos and the weight: 2 Dxu + 4).
    The backward needs per basis the projection, the phase, the sin, the
    coefficient and the Dxu-term update (4 Dxu + 4; no cos, no weight), per
    drift center the distance, the exp, the weighted gram and the Dxu-term
    update (4 Dxu + 8), and per policy center the recomputed forward (2 De +
    8) and its adjoint (the De-term input update and dzp's, 4 De + 6)."""
    x0, zp = ops[0], ops[1]
    k, ld, b, dxu = ops[7].shape
    s, m, (lp, mp, de) = x0.shape[0], ops[10].shape[2], zp.shape
    size = torch.finfo(dtype).bits // 8
    steps = meta.num_steps * s
    small = 2 * meta.state_dim * ld + 4 * de * de + 40  # encoder, Euler, cost
    fwd = lp * mp * (2 * de + 8) + ld * b * (2 * dxu + 4) + ld * m * (2 * dxu + 8) + small
    inputs = sum(t.numel() for t in ops)
    if kind == "fwd":
        outputs = s + (meta.num_steps + 1) * x0.numel()
        return _bound((inputs + outputs) * size, steps * fwd, dtype)
    # the small serial parts are recomputed and then differentiated
    bwd = lp * mp * (6 * de + 14) + ld * b * (4 * dxu + 4) + ld * m * (4 * dxu + 8) + 2 * small
    inputs += s + meta.num_steps * x0.numel() - x0.numel()  # gl; the trajectory replaces x0
    outputs = lp * mp * de + lp * mp + lp * de
    return _bound((inputs + outputs) * size, steps * bwd, dtype)


def rollout_outputs(rc, meta, ops, gl, kernel):
    """(loss, trajectory, dzp, dalpha, dilp) through the kernels or the
    plain versions."""
    if kernel:
        loss, traj = rc._fwd(meta, *ops)
        return (loss, traj, *rc._bwd(meta, traj, gl, *ops[1:]))
    loss, traj = rc._rollout(meta, *ops)
    return (loss, traj, *rc.rollout_reference_bwd(meta, traj, gl, *ops[1:]))


ROLL_OUTS = ("loss", "trajectory", "dzp", "dalpha", "dilp")


def rollout_kernels_phase(rc, seed, device, widths=ROLL_WIDTHS, tag=""):
    """Hold K6 (forward and backward) against its plain version at
    ``widths`` (rollout_operands' S, Lp, Ld, U, T, B, M, Mp, active dims and
    action scale) and time both beside the bound; the rows' names end in
    ``tag``. Bars: float64 over T steps, ROLL_F64_TOL of each output's
    scale; float32 over ROLL_SHORT_T steps, ROLL_F32_TOL of the scale;
    float32 over T steps, kernel and plain float32 both against float64 on
    the same inputs, the kernel within 3x the plain version's error plus
    1e-4 of the scale (match_kernels_phase's pattern: T float32 steps
    amplify rounding). The float32 forward must keep its tables in shared
    memory (the resident route), and the ring route must give its results
    bit for bit. At the cartpole's widths (no ``tag``) also, for
    correctness only: S=1000 (ragged against the backward's row tiles), the
    LCK shape (U=2, Lp=2, Ld=3) and the member axis (ROLL_MEMBERS members:
    all five outputs against the plain version at the float64 bar, and
    each member's losses bit-identical to a one-member call). The plain
    versions launch ~1000 small kernels a call, more than the launch queue
    holds, so they are timed by host wall time (plain_ms_of) after a short
    hold. Returns (errors, timings, the forward's route per dtype)."""
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)
    errs = {name + tag: 0.0 for name in rc.launches}
    timings, routes = {}, {}
    gl_of = lambda s, dtype: torch.full((s,), 1.0 / s, dtype=dtype, device=device)  # noqa: E731

    def record(sfx, what, got, want, tol=None):
        err = float((got.double() - want.double()).abs().max())
        name = f"rollout_{'fwd' if what in ('loss', 'trajectory') else 'bwd'}_{sfx}{tag}"
        errs[name] = max(errs[name], err)
        scaled = scaled_err(got, want)
        print(f"  {name} {what}: max |kernel - plain| = {err:.3e}, scaled {scaled:.3e}")
        if tol is not None and not (torch.isfinite(got).all() and scaled <= tol):
            raise AssertionError(f"{name} {what}: kernel disagrees with its plain version")
        return scaled

    f64, f32 = torch.float64, torch.float32
    s, b, m, steps = widths["s"], widths["b"], widths["m"], widths["steps"]
    meta, ops = rollout_operands(rc, 1, dtype=f64, device=device, seed=seed + 4000, **widths)
    for dtype, sfx in ((f32, "f32"), (f64, "f64")):
        routes[sfx], smem = rc.fwd_plan(meta, b, m, dtype)
        print(f"rollout_fwd_{sfx}{tag} at B={b} M={m}: the {routes[sfx]} route, {smem} bytes of dynamic "
              f"shared memory a block (cap {rc.FWD_SMEM_MAX})")
    print(f"rollout{tag} S={s} Ld={meta.num_latent} Lp={meta.pol_latent} U={meta.act_dim} B={b} M={m} "
          f"Mp={widths['mp']} T={steps} float64, bar {ROLL_F64_TOL:g} of the scale:")
    got = rollout_outputs(rc, meta, ops, gl_of(s, f64), True)
    want = rollout_outputs(rc, meta, ops, gl_of(s, f64), False)
    sync()
    for what, a, w in zip(ROLL_OUTS, got, want):
        record("f64", what, a, w, ROLL_F64_TOL)
    ops32 = tuple(o.float() for o in ops)
    print(f"rollout{tag} float32 over {steps} steps, kernel and plain float32 against float64 (3x + 1e-4):")
    got32 = rollout_outputs(rc, meta, ops32, gl_of(s, f32), True)
    plain32 = rollout_outputs(rc, meta, ops32, gl_of(s, f32), False)
    truth = rollout_outputs(rc, meta, tuple(o.double() for o in ops32), gl_of(s, f64), False)
    sync()
    for what, a, p, w in zip(ROLL_OUTS, got32, plain32, truth):
        record("f32", what, a, p)
        err_k, err_p = scaled_err(a, w), scaled_err(p, w)
        print(f"    vs float64: kernel {err_k:.3e}, plain float32 {err_p:.3e}")
        if not (torch.isfinite(a).all() and err_k <= 3.0 * err_p + 1e-4):
            raise AssertionError(f"rollout{tag} f32 {what}: the kernel is less accurate than plain float32")
    short = meta._replace(num_steps=ROLL_SHORT_T)
    print(f"rollout{tag} float32 over {ROLL_SHORT_T} steps, bar {ROLL_F32_TOL:g} of the scale:")
    got_s = rollout_outputs(rc, short, ops32, gl_of(s, f32), True)
    want_s = rollout_outputs(rc, short, ops32, gl_of(s, f32), False)
    sync()
    for what, a, w in zip(ROLL_OUTS, got_s, want_s):
        record("f32", what, a, w, ROLL_F32_TOL)
    if routes["f32"] != "resident":
        raise AssertionError(f"rollout{tag}: the float32 forward took the {routes['f32']} route")
    ring = rc._fwd(meta, *ops32, route="ring")
    if not (torch.equal(ring[0], got32[0]) and torch.equal(ring[1], got32[1])):
        raise AssertionError(f"rollout{tag}: the ring route differs from the resident route")
    print(f"rollout_fwd_f32{tag}: the ring route's loss and trajectory bit-identical to the resident route's")
    if not tag:
        rollout_extras(rc, seed, device, record, gl_of)

    for dtype, sfx, o in ((f32, "f32", ops32), (f64, "f64", ops)):
        gl = gl_of(s, dtype)
        traj, plain_traj = rc._fwd(meta, *o)[1], rc._rollout(meta, *o)[1]
        calls = {
            "fwd": (lambda o=o: rc._fwd(meta, *o), lambda o=o: rc._rollout(meta, *o)),
            "bwd": (lambda o=o, t=traj, g=gl: rc._bwd(meta, t, g, *o[1:]),
                    lambda o=o, t=plain_traj, g=gl: rc.rollout_reference_bwd(meta, t, g, *o[1:])),
        }
        for kind, (kern, plain) in calls.items():
            name = f"rollout_{kind}_{sfx}{tag}"
            ms = median_ms(kern, reps=10, flush=flush)
            warm_ms = median_ms(kern, reps=10)
            plain_ms, plain_how = plain_ms_of(plain, flush, reps=3, hold_s=0.2)
            bound, bound_by = rollout_bound_ms(kind, meta, o, dtype)
            # each launch's stages (warm L2): the forward's one; the
            # backward's jac, maps, adjoint, grads and slot sums
            stages = stage_ms(kern)
            timings[name] = dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms, plain_how=plain_how,
                                 bound_ms=bound, bound_by=bound_by, library_ms=None, stages=stages)
            print(f"  {name}: {ms:.4f} ms cold-L2 median ({warm_ms:.4f} ms warm), plain torch "
                  f"{plain_ms:.4f} ms ({plain_how}), bound {bound:.5f} ms ({bound_by}); stages "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items()))
    return errs, timings, routes


def rollout_extras(rc, seed, device, record, gl_of):
    """K6 at S=1000 and at the LCK shape, and on its member axis
    (ROLL_MEMBERS members), each at the float64 bar; each member's losses
    bit-identical to a one-member call."""
    f64 = torch.float64
    for label, args in (("S=1000", (1, 1000, 1, L, 1)), ("LCK U=2 Lp=2 Ld=3", (1, 256, 2, 3, 2))):
        m_x, o_x = rollout_operands(rc, *args, HORIZON_STEPS, f64, device, seed + 4001)
        print(f"rollout {label} float64, bar {ROLL_F64_TOL:g}:")
        gl = gl_of(o_x[0].shape[0], f64)
        for what, a, w in zip(ROLL_OUTS, rollout_outputs(rc, m_x, o_x, gl, True),
                              rollout_outputs(rc, m_x, o_x, gl, False)):
            record("f64", what, a, w, ROLL_F64_TOL)
    m_k, o_k = rollout_operands(rc, ROLL_MEMBERS, S, 1, L, 1, HORIZON_STEPS, f64, device, seed + 4002)
    print(f"rollout member axis {ROLL_MEMBERS} members x {S // ROLL_MEMBERS} particles float64, bar "
          f"{ROLL_F64_TOL:g}:")
    got_k = rollout_outputs(rc, m_k, o_k, gl_of(S, f64), True)
    for what, a, w in zip(ROLL_OUTS, got_k, rollout_outputs(rc, m_k, o_k, gl_of(S, f64), False)):
        record("f64", what, a, w, ROLL_F64_TOL)
    loss_k = got_k[0]
    per = S // ROLL_MEMBERS
    for j in range(ROLL_MEMBERS):
        rows = slice(j * per, (j + 1) * per)
        one = tuple(o[j:j + 1] if i in (7, 8, 9, 10, 11, 15) else o[rows] if i in (0, 12, 13) else o
                    for i, o in enumerate(o_k))
        if not torch.equal(rc._fwd(m_k, *one)[0], loss_k[rows]):
            raise AssertionError(f"rollout member {j}: the {ROLL_MEMBERS}-member call differs from "
                                 f"a one-member call")
    sync()
    print(f"rollout member axis: {ROLL_MEMBERS} members x {per} particles, each bit-identical to a "
          f"one-member call")


def _per_step_drift(drift, paths, x0):
    """The per-step path's drift: for an SVGP K1 in float32 and plain torch
    in float64; for a GPR (a stacked one for an ensemble) plain torch."""
    from gpflowpilco_torch.models.gp import GPR
    from gpflowpilco_torch.models.pathwise import PathwiseGPRTransform, PathwiseSVGPTransform

    if isinstance(drift, GPR):
        return PathwiseGPRTransform(drift, paths)
    return PathwiseSVGPTransform(drift, paths, fused=x0.dtype == torch.float32)


def _particle_loss_and_grad(loop, policy, drift, paths, x0, fused):
    """The mean particle loss and its policy gradient at the given paths and
    x0: through K6 when ``fused``, else the per-step path."""
    policy.zero_grad(set_to_none=True)
    if fused:
        loss = loop._fused_rollout_loss(policy, drift, paths, x0)
    else:
        loss = loop._particle_rollout_loss(policy, _per_step_drift(drift, paths, x0), x0)
    loss.backward()
    return float(loss.detach()), _flat_grads(policy)


def f64_rollout_hold(what, loop64, policy64, drift64, paths64, x064):
    """The float64 mean particle loss and policy gradient through K6
    against the per-step path in plain torch at the same paths and x0: the
    loss within max(1e-9, 10x the per-step loss's rounding noise, x0 moved
    by 1e-14, 1e-13 and 1e-12), the gradient at cosine >= 0.9999. Returns
    (relative gap, noise, cosine, the per-step gradient)."""
    (l_k, g_k), (l_u, g_u) = (_particle_loss_and_grad(loop64, policy64, drift64, paths64, x064, fused)
                              for fused in (True, False))
    with torch.no_grad():
        plain64 = _per_step_drift(drift64, paths64, x064)
        noise = max(abs(float(loop64._particle_rollout_loss(policy64, plain64, x064 + dx)) - l_u) / abs(l_u)
                    for dx in (1e-14, 1e-13, 1e-12))
    rel, bar = abs(l_k - l_u) / abs(l_u), max(1e-9, 10.0 * noise)
    cos64 = float(g_k @ g_u / (g_k.norm() * g_u.norm()))
    print(f"{what}: {loop64.episode_spec.num_steps}-step float64 loss via K6 {l_k:.15f}, per-step {l_u:.15f}, relative gap "
          f"{rel:.3e}; per-step rounding noise {noise:.3e}, bar {bar:.3e}; gradient cosine {cos64:.12f}")
    assert math.isfinite(l_k) and rel <= bar, f"{what}: K6 and per-step float64 losses disagree"
    assert cos64 >= 0.9999, f"{what}: K6 and per-step float64 gradients disagree"
    policy64.zero_grad(set_to_none=True)
    return rel, noise, cos64, g_u


def fused_rollout_slice_phase(rc, pe, loop, seed, device, step_limit):
    """The pathwise slice's fitted loop with use_fused_rollout: a policy
    update (counts zeroed just before and read just after: one K6 forward
    and one backward per Adam step, no K1), then at that state the float64
    loss and gradient through K6 against the unfused float64 path at the
    same paths and x0, and, printed, the float32 cosines."""
    from run_torch import build_loop

    from gpflowpilco_torch.models.pathwise import PathState, generate_paths_svgp

    loop.use_fused_rollout = True
    assert loop._fused_rollout_eligible(loop.drift_model, loop.policy_model)
    before = {n: p.detach().clone() for n, p in loop.policy_model.named_parameters()}
    rc.reset_launches()
    pe.reset_launches()
    cap = graph_captures()
    t0 = time.perf_counter()
    info_p = loop.update_policy()
    sync()
    t_pol = time.perf_counter() - t0
    delta = {**rc.launches, **pe.launches}
    print(f"fused rollout: policy update {1e3 * t_pol:.1f} ms = {1e3 * t_pol / step_limit:.2f} ms per "
          f"fused-rollout policy step; loss {info_p['loss']:.5f}, skipped {info_p['skipped_steps']}; "
          f"launches {delta}")
    assert math.isfinite(info_p["loss"]), "fused-rollout policy loss is not finite"
    want = dict.fromkeys(delta, 0)
    cap = graph_captures() - cap
    want.update(rollout_fwd_f32=step_limit + cap, rollout_bwd_f32=step_limit + cap)
    assert delta == want, f"launches {delta}, expected {want}"
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in loop.policy_model.named_parameters() if p.requires_grad)
    assert moved > 0, "policy parameters did not change"
    launches = dict(rc.launches)

    # ---- float64 at that state: K6 against the unfused path at the same
    # paths and x0 (drawn once in float32 and cast); bar max(1e-9, 10x the
    # unfused loss's rounding noise, x0 moved by 1e-14, 1e-13, 1e-12)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    drift, policy = loop.policy_loss_drift(), loop.policy_model
    with torch.no_grad():
        paths = generate_paths_svgp(drift, gen, S, B)
        x0 = loop.episode_spec.sample(gen, (S,), dtype=torch.float32, device=device)
    loop64 = build_loop(seed, device, torch.float64, policy_spec=loop.policy_spec)
    loop64.use_fused_rollout = True
    rel, noise, cos64, g_u = f64_rollout_hold(
        "fused rollout", loop64, copy.deepcopy(policy).double(), copy.deepcopy(drift).double(),
        PathState(*(p.double() for p in paths)), x0.double())

    # ---- printed, not asserted: the float32 gradients (K6 and the K1 path)
    # against each other and against float64 (30 float32 steps are chaotic)
    f32 = {name: _particle_loss_and_grad(loop, policy, drift, paths, x0, fused)
           for name, fused in (("K6 f32", True), ("unfused f32", False))}
    cos = lambda a, b: float(a @ b / (a.norm() * b.norm()))  # noqa: E731
    print(f"fused rollout: float32 losses K6 {f32['K6 f32'][0]:.6f}, unfused {f32['unfused f32'][0]:.6f}; "
          f"gradient cosines K6-vs-unfused {cos(f32['K6 f32'][1], f32['unfused f32'][1]):.6f}, "
          f"K6 f32-vs-f64 {cos(f32['K6 f32'][1], g_u):.6f}, unfused f32-vs-f64 "
          f"{cos(f32['unfused f32'][1], g_u):.6f}")
    policy.zero_grad(set_to_none=True)
    return launches, dict(policy_step_ms=1e3 * t_pol / step_limit, f64_rel_gap=rel, f64_noise=noise,
                          f64_grad_cos=cos64)


def policy_loop_phase(rc, pe, loop, seed, device, step_limit):
    """The policy loop on the fused-rollout slice's fitted loop, at full
    width: (a) a K=4 multistart update through K6 with the best-validated
    snapshot as candidate 1 (4 x step_limit K6 forwards and backwards, no
    K1; the snapshot bit-identical afterwards); (b) a K=2 x 5-step
    multistart through K1 (2 x 5 x 30 K1a forwards and K1b dx-only
    backwards, no K1c, no K6); (c) 100-rollout validation of the deployed
    policy with the cartpole success mask, 3 of its rewards held against
    serial rollouts of the same x0 (1e-5 relative, float32); (d) a
    checkpoint round trip into a fresh loop: episodes and q_mu
    bit-identical, and one K6 loss at the restored state equal to the
    original's bit for bit. Counts are zeroed just before each update and
    read just after."""
    import tempfile

    from metrics_torch import success_mask
    from run_torch import build_loop

    from gpflowpilco_torch.envs.base import rollout as env_rollout
    from gpflowpilco_torch.loops.metrics import deployed_policy, make_validation_metrics, validation_rollouts
    from gpflowpilco_torch.loops.pilco import _VALIDATION

    def reset():
        rc.reset_launches()
        pe.reset_launches()

    def counts():
        return {**rc.launches, **pe.launches}

    spec0 = loop.policy_spec
    out = {}

    # ---- (a) K=4 multistart through K6, the snapshot as candidate 1
    assert loop.use_fused_rollout and loop.best_policy_model is not None
    loop.policy_spec = dataclasses.replace(spec0, num_restarts=4, retain_best_policy=True,
                                           step_limit=step_limit)
    snapshot = loop.best_policy_model
    snap0 = {n: p.detach().clone() for n, p in snapshot.named_parameters()}
    reset()
    cap = graph_captures()
    t0 = time.perf_counter()
    info = loop.update_policy()
    sync()
    t_a = time.perf_counter() - t0
    delta = counts()
    out["multistart_k6_ms_per_candidate_step"] = 1e3 * t_a / (4 * step_limit)
    print(f"policy loop (a): K=4 x {step_limit} steps through K6 in {1e3 * t_a:.1f} ms = "
          f"{out['multistart_k6_ms_per_candidate_step']:.2f} ms per candidate step; best_restart "
          f"{info['best_restart']}, restart_losses {info['restart_losses']}, skipped "
          f"{info['skipped_steps']}; launches {delta}")
    want = dict.fromkeys(delta, 0)
    cap = graph_captures() - cap
    want.update(rollout_fwd_f32=4 * step_limit + cap, rollout_bwd_f32=4 * step_limit + cap)
    assert delta == want, f"(a) launches {delta}, expected {want}"
    assert info["best_restart"] == int(np.argmin(info["restart_losses"])), "(a) the winner is not the argmin"
    assert math.isfinite(info["loss"]), "(a) the best loss is not finite"
    assert loop.best_policy_model is snapshot and all(
        torch.equal(p, snap0[n]) for n, p in snapshot.named_parameters()), "(a) the snapshot moved"
    launches = dict(rc.launches)

    # ---- (b) K=2 x 5 steps through K1 (the per-step path, use_fused_paths)
    loop.use_fused_rollout = False
    loop.policy_spec = dataclasses.replace(loop.policy_spec, num_restarts=2, step_limit=5)
    reset()
    t0 = time.perf_counter()
    info_b = loop.update_policy()
    sync()
    t_b = time.perf_counter() - t0
    delta = counts()
    want = dict.fromkeys(delta, 0)
    want.update(path_eval_fwd=2 * 5 * HORIZON_STEPS, path_eval_bwd_dx=2 * 5 * HORIZON_STEPS)
    outside = {k: delta[k] - want[k] for k in delta}
    print(f"policy loop (b): K=2 x 5 steps through K1 in {1e3 * t_b:.1f} ms = {1e3 * t_b / 10:.2f} ms per "
          f"candidate step; best_restart {info_b['best_restart']}; launches {delta}; outside the Adam "
          f"steps {outside}")
    assert delta == want, f"(b) launches {delta}, expected {want}"
    assert math.isfinite(info_b["loss"]), "(b) the best loss is not finite"
    loop.use_fused_rollout = True
    loop.policy_spec = spec0

    # ---- (c) 100-rollout validation, 3 rollouts held against serial ones
    validation = make_validation_metrics(lambda lp, st: success_mask(lp.env, st), 100)
    t0 = time.perf_counter()
    v = validation(loop, None, None)
    sync()
    t_c = time.perf_counter() - t0
    out["validation_s"] = t_c
    print(f"policy loop (c): validation of 100 rollouts in {t_c:.3f} s: vReward {v['vReward']:.6f}, "
          f"vSuccess {v['vSuccess']:.2f}")
    assert math.isfinite(v["vReward"]) and 0.0 <= v["vSuccess"] <= 1.0, f"(c) validation {v}"
    spec = loop.episode_spec
    model = deployed_policy(loop)
    x0 = spec.sample(loop.iteration_generator(_VALIDATION), (100,), dtype=loop.dtype, device=device)
    rewards, _ = validation_rollouts(loop, model, x0)
    assert abs(float(rewards.mean()) - v["vReward"]) <= 1e-6 * abs(v["vReward"]), "(c) validation reruns differ"
    for i in (0, 50, 99):
        with torch.no_grad():
            states, _ = env_rollout(loop.env, loop.policy_fn(model), x0[i], spec.step_size, spec.num_steps,
                                    loop.env_substeps)
            serial = float(-torch.sum(loop.objective(loop.encode(states))))
        rel = abs(float(rewards[i]) - serial) / abs(serial)
        print(f"policy loop (c): rollout {i}: batched reward {float(rewards[i]):.7f}, serial {serial:.7f}, "
              f"relative gap {rel:.3e}")
        assert rel <= 1e-5, f"(c) rollout {i}: batched and serial rewards disagree"

    # ---- (d) checkpoint round trip into a fresh loop on the card
    with tempfile.TemporaryDirectory() as tmp:
        loop.directory = Path(tmp)
        path = loop.save()
        loop.directory = None
        fresh = build_loop(seed, device, torch.float32, policy_spec=loop.policy_spec, directory=tmp)
        print(f"policy loop (d): {path.name}, {path.stat().st_size} bytes; restored "
              f"{len(fresh.episodes)} episodes")
    assert len(fresh.episodes) == len(loop.episodes) and all(
        np.array_equal(a.states, b.states) and np.array_equal(a.actions, b.actions)
        for a, b in zip(fresh.episodes, loop.episodes)), "(d) the episodes differ"
    assert torch.equal(fresh.drift_model.q_mu, loop.drift_model.q_mu), "(d) the drift q_mu differs"
    assert torch.equal(fresh.policy_model.q_mu, loop.policy_model.q_mu), "(d) the policy q_mu differs"
    fresh.use_fused_rollout = True
    reset()
    with torch.no_grad():
        losses = [
            float(lp.policy_loss_fn(lp.policy_model, torch.Generator(device=device).manual_seed(seed + 3),
                                    drift=lp.policy_loss_drift()))
            for lp in (loop, fresh)
        ]
    print(f"policy loop (d): K6 loss at the original {losses[0]!r}, at the restored {losses[1]!r}; "
          f"launches {counts()}")
    assert rc.launches["rollout_fwd_f32"] == 2, "(d) the losses did not run through K6"
    assert losses[0] == losses[1], "(d) the restored loss differs"
    return launches, out


# ---------------------------------------------------------------- slice E: scale-out
SCALE_STEPS = 5  # Adam steps of each sharded route
SCALE_HMC = dict(num_warmup=30, num_samples=20, num_leapfrog=8)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _cos(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def _sharded_route(loss_fn, policy, seed, device, group):
    """The sharded loss and its dp-summed policy gradient on the draws of a
    generator seeded ``seed``."""
    from gpflowpilco_torch.parallel.pathwise import allreduce_gradients

    policy.zero_grad(set_to_none=True)
    loss = loss_fn(policy, torch.Generator(device=device).manual_seed(seed))
    loss.backward()
    allreduce_gradients(policy.parameters(), group)
    out = float(loss.detach()), _flat_grads(policy)
    policy.zero_grad(set_to_none=True)
    return out


def _timed_steps(step_fn, n):
    """ms per call of step_fn(i) over n calls, the device synced after each."""
    sync()
    t0 = time.perf_counter()
    losses = []
    for i in range(n):
        losses.append(float(step_fn(i)))
        sync()
    return 1e3 * (time.perf_counter() - t0) / n, losses


def _scaleout_rank(rank, world, port, job, out_dir):
    """One of the two gloo ranks of the scale-out phase (ii) on the one
    card: route (c) at dp = 2, each rank 512 particles of the 1024. The
    kernels were built by the parent; this process loads them."""
    import torch.distributed as dist

    from gpflowpilco_torch.components import GaussianObjective, trigonometric_encoder
    from gpflowpilco_torch.convert import svgp_from_numpy
    from gpflowpilco_torch.loops.core import EpisodeSpec
    from gpflowpilco_torch.models.builders import policy_mask
    from gpflowpilco_torch.ops import rollout_cuda as rc
    from gpflowpilco_torch.parallel.mesh import make_mesh
    from gpflowpilco_torch.parallel.pathwise import make_pathwise_train_step

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)  # both ranks on the one card
        mesh = make_mesh(world, 1, backend="gloo")
        drift = svgp_from_numpy(job["drift"], device, torch.float32).requires_grad_(False)
        policy = svgp_from_numpy(job["policy"], device, torch.float32)
        policy_mask(policy)
        encoder = trigonometric_encoder(active_dims=job["active"])
        objective = GaussianObjective.create(target=torch.as_tensor(job["target"], device=device),
                                             precis=torch.as_tensor(job["precis"], device=device))
        opt = torch.optim.Adam(policy.parameters(), lr=job["lr"])
        step, loss_fn = make_pathwise_train_step(
            mesh, drift, None, encoder, objective, EpisodeSpec(**job["spec"]), batch_size=S, num_bases=B,
            optimizer=opt, dtype=torch.float32, fused_rollout=True, action_scale=job["action_scale"])
        rc.reset_launches()
        loss, grad = _sharded_route(loss_fn, policy, job["seed"], device, mesh.get_group("dp"))
        sync()
        per_loss = dict(rc.launches)
        rc.reset_launches()
        cap = graph_captures()
        ms, losses = _timed_steps(
            lambda i: step(policy, torch.Generator(device=device).manual_seed(job["seed"] + 1 + i)), SCALE_STEPS)
        torch.save(dict(loss=loss, grad=grad.cpu(), per_loss=per_loss, steps=dict(rc.launches), ms=ms,
                        losses=losses, rows=job["rows"], captures=graph_captures() - cap),
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def scaleout_phase(rc, pe, loop, seed, device):
    """Slice E on the pathwise slice's fitted loop at full width (1024
    particles x 1024 bases x 30 steps, float32, SVGP drift M=240):
    (i) world size 1 over NCCL, in this process: the sharded loss and
    gradient of routes (b) (K1, use_fused_paths) and (c) (K6) held
    against PathwisePILCO.policy_loss_fn on the same draws (loss relative
    1e-6, gradient cosine >= 0.99999), the sharded float64 K6 loss
    against the unsharded one at the same paths and x0 (1e-10 relative),
    SCALE_STEPS Adam steps of each route, all finite (K1: 30 forwards and
    30 dx-only backwards a step; K6: one forward and one backward), timed
    beside the same steps unsharded; (iii) run_hmc_sharded against
    run_hmc (8 float64 chains, rounding) and the sharded resampler
    against the local one (bit for bit), at that world size; (ii) two gloo
    ranks on the one card (NCCL refuses two ranks on one device): route
    (c) at dp = 2, 512 particles a rank, its loss and gradient held
    against (i)'s by the same bars, and its steps timed."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from gpflowpilco_torch.convert import svgp_to_numpy
    from gpflowpilco_torch.loops.pilco import fused_rollout_costs
    from gpflowpilco_torch.models.hmc import HMCConfig, run_hmc
    from gpflowpilco_torch.models.pathwise import PathState, generate_paths_svgp
    from gpflowpilco_torch.parallel.hmc import run_hmc_sharded
    from gpflowpilco_torch.parallel.mesh import make_mesh
    from gpflowpilco_torch.parallel.pathwise import make_pathwise_train_step
    from gpflowpilco_torch.parallel.resample import systematic_resample, systematic_resample_sharded

    out, secs = {}, {}
    drift, policy0 = loop.policy_loss_drift(), loop.policy_model
    spec, action_scale, lr = loop.episode_spec, float(loop.policy_spec.action_scale), 1e-3
    fused_paths0, fused_rollout0 = loop.use_fused_paths, loop.use_fused_rollout
    seed_d = seed + 500

    def make(mesh, pol, **kw):
        opt = torch.optim.Adam(pol.parameters(), lr=lr)
        step, loss_fn = make_pathwise_train_step(
            mesh, drift, loop.policy_chain, loop.encoder, loop.objective, spec, batch_size=S, num_bases=B,
            optimizer=opt, dtype=torch.float32, action_scale=action_scale, **kw)
        return step, loss_fn, opt

    def counts():
        return {**{k: v for k, v in pe.launches.items() if v}, **{k: v for k, v in rc.launches.items() if v}}

    # ---- (i) world size 1 over NCCL
    t_i = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        group = mesh.get_group("dp")
        per_step = {"fused": dict(path_eval_fwd=HORIZON_STEPS, path_eval_bwd_dx=HORIZON_STEPS),
                    "fused_rollout": dict(rollout_fwd_f32=1, rollout_bwd_f32=1)}
        for route, (paths_on, rollout_on) in (("fused", (True, False)), ("fused_rollout", (False, True))):
            pol = copy.deepcopy(policy0)
            step, loss_fn, _ = make(mesh, pol, **{route: True})
            rc.reset_launches()
            pe.reset_launches()
            l_sh, g_sh = _sharded_route(loss_fn, pol, seed_d, device, group)
            sync()
            got_counts = counts()
            loop.use_fused_paths, loop.use_fused_rollout = paths_on, rollout_on
            ref = copy.deepcopy(policy0)
            loss = loop.policy_loss_fn(ref, torch.Generator(device=device).manual_seed(seed_d), drift=drift)
            loss.backward()
            l_ref, g_ref = float(loss.detach()), _flat_grads(ref)
            rel, cos = abs(l_sh - l_ref) / abs(l_ref), _cos(g_sh, g_ref)
            print(f"scale-out (i) {route}: sharded loss {l_sh:.8f}, PathwisePILCO.policy_loss_fn {l_ref:.8f}, "
                  f"relative gap {rel:.3e}; gradient cosine {cos:.9f}, norm ratio "
                  f"{float(g_sh.norm() / g_ref.norm()):.9f}; launches per loss+grad {got_counts}")
            assert math.isfinite(l_sh) and rel <= 1e-6, f"scale-out (i) {route}: the losses disagree"
            assert cos >= 0.99999, f"scale-out (i) {route}: the gradients disagree"
            assert got_counts == per_step[route], f"scale-out (i) {route}: launches {got_counts}"
            out[f"{route}_loss"], out[f"{route}_grad"] = l_sh, g_sh

            # Adam steps sharded and unsharded in turns (sharded, unsharded,
            # unsharded, sharded), SCALE_STEPS each, timed
            opt_ref = torch.optim.Adam(ref.parameters(), lr=lr)

            def plain_step(i):
                opt_ref.zero_grad(set_to_none=True)
                loss = loop.policy_loss_fn(ref, torch.Generator(device=device).manual_seed(seed_d + 1 + i),
                                           drift=drift)
                loss.backward()
                opt_ref.step()
                return loss.detach()

            def sharded_step(i):
                return step(pol, torch.Generator(device=device).manual_seed(seed_d + 1 + i))

            rc.reset_launches()
            pe.reset_launches()
            cap = graph_captures()
            ms, ms_plain, losses, losses_plain = [], [], [], []
            for fn, times, seen, first in ((sharded_step, ms, losses, 0), (plain_step, ms_plain, losses_plain, 0),
                                           (plain_step, ms_plain, losses_plain, SCALE_STEPS),
                                           (sharded_step, ms, losses, SCALE_STEPS)):
                t, ls = _timed_steps(lambda i: fn(first + i), SCALE_STEPS)
                times.append(t)
                seen.extend(ls)
            got_counts = counts()
            cap = graph_captures() - cap
            want_counts = {k: 4 * SCALE_STEPS * v + (cap if k.startswith("rollout_") else 0)
                           for k, v in per_step[route].items()}
            assert all(math.isfinite(v) for v in losses), f"scale-out (i) {route}: losses {losses}"
            assert got_counts == want_counts, f"scale-out (i) {route}: launches {got_counts}"
            print(f"scale-out (i) {route}: 2 x {SCALE_STEPS} Adam steps sharded at world size 1, "
                  f"{' and '.join(f'{t:.2f}' for t in ms)} ms a step; unsharded, in turns, "
                  f"{' and '.join(f'{t:.2f}' for t in ms_plain)} ms a step; launches in all {got_counts}; "
                  f"losses sharded {[round(v, 6) for v in losses]}, unsharded {[round(v, 6) for v in losses_plain]}")
            out[f"{route}_step_ms_world1"], out[f"{route}_step_ms_unsharded"] = ms, ms_plain

        # float64: the sharded K6 loss against the unsharded one at the same paths and x0
        pol64, drift64 = copy.deepcopy(policy0).double(), copy.deepcopy(drift).double()
        gen = torch.Generator(device=device).manual_seed(seed_d)
        with torch.no_grad():
            paths64 = PathState(*(p.double() for p in generate_paths_svgp(drift, gen, S, B)))
            x064 = spec.sample(gen, (S,), dtype=torch.float32, device=device).double()
        _, loss64_fn = make_pathwise_train_step(
            mesh, drift64, loop.policy_chain, loop.encoder, loop.objective, spec, batch_size=S, num_bases=B,
            optimizer=torch.optim.Adam(pol64.parameters()), dtype=torch.float64, fused_rollout=True,
            action_scale=action_scale)
        with torch.no_grad():
            rc.reset_launches()
            l_sh = float(loss64_fn(pol64, paths=paths64, x0=x064))
            l_un = float(fused_rollout_costs(pol64, drift64, paths64, x064, loop.encoder, loop.objective,
                                             action_scale, spec.num_steps).mean())
        rel = abs(l_sh - l_un) / abs(l_un)
        print(f"scale-out (i) float64 K6: sharded {l_sh:.15f}, unsharded {l_un:.15f}, relative gap {rel:.3e}; "
              f"launches {counts()}")
        assert rel <= 1e-10 and rc.launches["rollout_fwd_f64"] == 2, "scale-out (i): the float64 K6 losses disagree"
        secs["i"] = time.perf_counter() - t_i

        # ---- (iii) sharded HMC and resampling at world size 1
        t_iii = time.perf_counter()
        cfg = HMCConfig(**SCALE_HMC)
        mean = torch.linspace(-1.0, 1.0, 6, dtype=torch.float64, device=device)

        def log_prob(q):
            return -0.5 * torch.sum((q - mean) ** 2, -1)

        q_init = torch.randn((8, 6), generator=torch.Generator(device=device).manual_seed(seed_d), dtype=torch.float64,
                             device=device)
        runs = [fn(log_prob, q_init, torch.Generator(device=device).manual_seed(seed_d + 1), *a, cfg)
                for fn, a in ((run_hmc_sharded, (mesh,)), (run_hmc, ()))]
        gap = float((runs[0].samples - runs[1].samples).abs().max() / runs[1].samples.abs().max())
        acc = float(runs[0].accept_prob.mean())
        print(f"scale-out (iii): run_hmc_sharded against run_hmc, 8 chains x {cfg.num_samples} samples: "
              f"relative gap {gap:.3e}, acceptance {acc:.3f}, step size {float(runs[0].step_size):.5f}")
        assert gap <= 1e-10 and 0.0 < acc <= 1.0, "scale-out (iii): sharded HMC differs"
        weights = torch.rand((S,), generator=torch.Generator(device=device).manual_seed(seed_d + 2),
                             dtype=torch.float64, device=device)
        states = spec.sample(torch.Generator(device=device).manual_seed(seed_d + 3), (S,), dtype=torch.float32,
                             device=device)
        res = [systematic_resample_sharded(torch.Generator(device=device).manual_seed(seed_d + 4), weights,
                                           states, mesh),
               systematic_resample(torch.Generator(device=device).manual_seed(seed_d + 4), weights, states)]
        print(f"scale-out (iii): sharded resampling of {S} states equals the local one: {torch.equal(*res)}")
        assert torch.equal(*res), "scale-out (iii): the sharded resampler differs"
        secs["iii"] = time.perf_counter() - t_iii
    finally:
        dist.destroy_process_group()
        loop.use_fused_paths, loop.use_fused_rollout = fused_paths0, fused_rollout0

    # ---- (ii) two gloo ranks on the one card, route (c) at dp = 2
    t_ii = time.perf_counter()
    job = dict(drift=svgp_to_numpy(drift), policy=svgp_to_numpy(policy0), active=tuple(loop.encoder.active_dims),
               target=loop.objective.target.cpu().numpy(), precis=loop.objective.precis.cpu().numpy(),
               spec=dict(spec._asdict()), action_scale=action_scale, lr=lr, seed=seed_d, rows=S // 2)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        procs = [ctx.Process(target=_scaleout_rank, args=(r, 2, port, job, tmp)) for r in range(2)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(300)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        assert all(proc.exitcode == 0 for proc in procs), \
            f"scale-out (ii): ranks exited {[proc.exitcode for proc in procs]}"
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(2)]
    g_one = out["fused_rollout_grad"].cpu()
    for r, res in enumerate(ranks):
        rel = abs(res["loss"] - out["fused_rollout_loss"]) / abs(out["fused_rollout_loss"])
        cos = _cos(res["grad"], g_one)
        print(f"scale-out (ii) rank {r}: {res['rows']} particles; loss {res['loss']:.8f} against world size 1's "
              f"{out['fused_rollout_loss']:.8f}, relative gap {rel:.3e}; gradient cosine {cos:.9f}; launches per "
              f"loss+grad {res['per_loss']}; {SCALE_STEPS} Adam steps {res['ms']:.2f} ms a step (launches "
              f"{res['steps']}, losses {[round(v, 6) for v in res['losses']]})")
        assert rel <= 1e-6 and cos >= 0.99999, f"scale-out (ii) rank {r}: differs from world size 1"
        assert res["per_loss"]["rollout_fwd_f32"] == 1 and res["per_loss"]["rollout_bwd_f32"] == 1
        assert res["steps"]["rollout_fwd_f32"] == SCALE_STEPS + res["captures"]
        assert all(math.isfinite(v) for v in res["losses"])
    out["fused_rollout_step_ms_dp2"] = max(res["ms"] for res in ranks)
    secs["ii"] = time.perf_counter() - t_ii
    print(f"scale-out: sub-phase seconds {json.dumps({k: round(v, 1) for k, v in secs.items()})}")
    return {k: v for k, v in out.items() if not k.endswith(("_grad", "_loss"))}


# ---------------------------------------------------------------- slice D: the other two tasks
# The double pendulum's full width (examples/double_pendulum/run_torch.py's
# defaults, the JAX full run's): state D=4 with both angles encoded (6
# features), a 2-D torque; an LCK drift of 4 latents over 4 outputs at
# M=320 (8 random episodes of 50 steps give N=400), an LCK policy of 2
# latents at M=100; 1024 particles x 1024 bases, T=50 steps of 0.05 s.
# Mountain car's: state D=2 and no encoder, a 1-D force; drift M=128, policy
# M=20, T=50 steps of 0.1 s.
DP_S, DP_B, DP_M, DP_MP, DP_LD, DP_LP, DP_U, DP_T, DP_ACTIVE = 1024, 1024, 320, 100, 4, 2, 2, 50, (0, 1)
DP_DE = 4 + len(DP_ACTIVE)
MC_M, MC_MP, MC_T = 128, 20, 50
# K1 at the drifts' paths: (S, L, B, M, D) with D the drift's input
# (features and action)
DP_PATHS, MC_PATHS = (DP_S, DP_LD, DP_B, DP_M, DP_DE + DP_U), (DP_S, 2, DP_B, MC_M, 3)
# K2 at the double pendulum's MM shapes, (N, P, D2, M): the drift match
# (P = L(L+1)/2 latent pairs, D2 = 2 * 8 + 2 = 18 > 16: the DM = 32 route)
# and the policy match (P = 3 pairs of its 2 latents, D2 = 2 * 6 + 2)
DP_PAIR_SHAPES = {"drift": (1, DP_LD * (DP_LD + 1) // 2, 2 * (DP_DE + DP_U) + 2, DP_M),
                  "policy": (1, DP_LP * (DP_LP + 1) // 2, 2 * DP_DE + 2, DP_MP)}
# K3 at the drift's (L=4, D=8, M=320, with model uncertainty; forward and
# frozen backward: the drift match is frozen on the path) and the policy's
# (L=2, D=6, M=100; forward and full backward) shapes; K4 with both angles active (NA=2); K5a
# on the policy joint (6 features and 2 torques: D=8)
DP_MATCH_SHAPES = {"drift": (1, DP_LD, DP_DE + DP_U, DP_M, True, False),
                   "policy": (1, DP_LP, DP_DE, DP_MP, False, True)}
# K6 at the double pendulum's widths (DXU = 8: two warps a particle)
DP_ROLL_WIDTHS = dict(s=DP_S, lp=DP_LP, ld=DP_LD, u=DP_U, steps=DP_T, b=DP_B, m=DP_M, mp=DP_MP,
                      active=DP_ACTIVE, action_scale=2.0)
TASK_MM_STEPS = 3  # Adam steps of the double pendulum's MM updates (b)
TASK_K1_STEPS = 5  # Adam steps of the updates through K1 (a) and (c)


def load_runner(task):
    """examples/<task>/run_torch.py as the module ``<task>_run_torch`` (the
    cartpole's runner is imported as ``run_torch``)."""
    import importlib.util

    name = f"{task}_run_torch"
    if name not in sys.modules:
        path = Path(__file__).resolve().parent / "examples" / task / "run_torch.py"
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def task_loop(task, loop_cls, seed, device, dtype, lbfgs_iters, **policy):
    """The task's loop at the full run's specs (its runner's defaults), the
    drift fit cut to ``lbfgs_iters`` L-BFGS iterations, one policy
    candidate, no validation rollouts, ``policy`` overriding the policy
    spec."""
    run = load_runner(task)
    args = run.parser().parse_args([])
    drift, pol, _, _ = run.run_specs(args)
    return run.build_loop(
        seed, device, dtype,
        drift_spec=dataclasses.replace(drift, max_iters=lbfgs_iters),
        policy_spec=dataclasses.replace(pol, **{"num_restarts": 1, **policy}),
        step_size=args.dt, horizon=args.horizon, loop_cls=loop_cls, validation_samples=0,
    )


def counted_update(loop, counters, what):
    """A policy update with every count zeroed just before and read just
    after; returns (info, the launches, the particle loss's graph captures
    made meanwhile (``graph_captures``), seconds)."""
    for c in counters:
        c.reset_launches()
    cap = graph_captures()
    before = {n: p.detach().clone() for n, p in loop.policy_model.named_parameters()}
    t0 = time.perf_counter()
    info = loop.update_policy()
    sync()
    seconds = time.perf_counter() - t0
    cap = graph_captures() - cap
    delta = {k: v for c in counters for k, v in c.launches.items()}
    steps = loop.policy_spec.step_limit
    print(f"{what}: {steps} Adam steps in {1e3 * seconds:.1f} ms = {1e3 * seconds / steps:.2f} ms a step; "
          f"loss {info['loss']:.6f}, skipped {info['skipped_steps']}; launches "
          f"{ {k: v for k, v in delta.items() if v} }")
    assert math.isfinite(info["loss"]), f"{what}: the policy loss is not finite"
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in loop.policy_model.named_parameters() if p.requires_grad)
    assert moved > 0, f"{what}: the policy parameters did not change"
    return info, delta, cap, seconds


def expect(delta, per_step, steps, what, captures=0):
    """The launches must be ``per_step`` x ``steps`` and none of any other
    kernel, plus one K6 launch of each kind the update runs for each of its
    graph ``captures`` (the capture's side-stream warm-up)."""
    want = {k: per_step.get(k, 0) * steps + (captures if k.startswith("rollout_") and per_step.get(k) else 0)
            for k in delta}
    assert delta == want, f"{what}: launches {delta}, expected {want}"


def tasks_phase(counters, seed, device, step_limit, lbfgs_iters, jacobi_gap):
    """Slice D: the double pendulum and mountain car at full width, through
    their runners' build_task and build_loop with the full runs' specs.

    (a) Double pendulum, pathwise: 8 random episodes (N=400, so M=320), an
    L-BFGS LCK drift fit (cut to ``lbfgs_iters``), a policy update through
    K6 (one forward and one backward per Adam step, no K1; the forward's
    route printed), a TASK_K1_STEPS-step update through K1 (50 K1a forwards
    and 50 K1b backwards a step), one RK4 episode; then the float64 loss and
    gradient through K6 against the per-step path at the same paths and x0
    (f64_rollout_hold: max(1e-9, 10x the loss's rounding noise), cosine >=
    0.9999). (b) Double pendulum, MM, on (a)'s data and drift: a
    TASK_MM_STEPS-step use_fused_mm update with the float64 loss and the
    float32 policy island (per Adam step 50 float64 K2 forwards and frozen
    backwards, 50 float32 forwards and full backwards), the float64 loss
    through K2 against the unfused one (phase 5's bar); a TASK_MM_STEPS-step
    use_fused_match update in float32 (per step 100 K3 forwards, 50 frozen
    and 50 full K3 backwards, 51 K4 forwards and 50 backwards, 50 K5a and 50
    K5b), the float64 whole-match loss against the unfused one (phase 7's
    bar, Jacobi gap included). (c) Mountain car: 8 random episodes, a drift
    fit (M=128), a TASK_MM_STEPS-step use_fused_mm update (float32 loss: per
    step 100 K2 forwards, 50 frozen and 50 full backwards), a
    TASK_K1_STEPS-step pathwise update through K1 (D=3, L=2; no encoder, so
    never K6), one RK4 episode. (d) On (a)'s data: the drift fit by
    'adam' and 'natgrad_adam' (cut to ``lbfgs_iters``), each timed, its ELBO
    printed beside L-BFGS's. Returns (launches by row name, the times)."""
    from gpflowpilco_torch.loops.driver import outer_loop
    from gpflowpilco_torch.loops.pilco import MomentMatchingPILCO, PathwisePILCO
    from gpflowpilco_torch.models.gp import svgp_elbo
    from gpflowpilco_torch.models.pathwise import PathState, fused_rollout_operands, generate_paths_svgp

    pe, kc, mc, ec, gc, rc = counters
    f32, f64 = torch.float32, torch.float64
    out, rows = {}, {}

    # ---- (a) double pendulum, pathwise, full width
    loop = task_loop("double_pendulum", PathwisePILCO, seed, device, f32, lbfgs_iters, step_limit=step_limit)
    assert loop.episode_spec.num_steps == DP_T and loop.policy_spec.batch_size == DP_S
    t0 = time.perf_counter()
    outer_loop(loop, num_episodes=8, num_episodes_init=8, log_summaries=False)
    out["dp_random_episodes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info_d = loop.update_dynamics()
    sync()
    out["dp_lbfgs_s"] = time.perf_counter() - t0
    drift = loop.drift_model
    print(f"tasks (a): double pendulum, 8 random episodes in {out['dp_random_episodes_s']:.2f} s; L-BFGS "
          f"LCK drift fit {out['dp_lbfgs_s']:.2f} s, loss {info_d['loss']:.4f}, {info_d['iters']} "
          f"iterations; M={drift.num_inducing}, W {tuple(drift.w.shape)}, noise "
          f"{tuple(drift.noise_variance.shape)}")
    assert math.isfinite(info_d["loss"]) and drift.num_inducing == DP_M and drift.w.shape == (4, DP_LD)
    loop.policy_model = loop.build_policy()
    assert loop.policy_model.num_inducing == DP_MP and loop.policy_model.w.shape == (DP_U, DP_LP)
    loop.use_fused_rollout = True
    assert loop._fused_rollout_eligible(drift, loop.policy_model)
    with torch.no_grad():
        paths = generate_paths_svgp(drift, torch.Generator(device=device).manual_seed(seed), 8, DP_B)
        meta, _ = fused_rollout_operands(
            loop.policy_model, drift, paths, state_dim=4, active_dims=DP_ACTIVE, action_scale=2.0,
            target=loop.objective.target, precis=loop.objective.precis, num_steps=DP_T)
    route, smem = rc.fwd_plan(meta, DP_B, DP_M, f32)
    print(f"tasks (a): K6's forward takes the {route} route ({smem} bytes of shared memory a block)")
    _, delta, cap, sec = counted_update(loop, counters, "tasks (a) update through K6")
    expect(delta, {"rollout_fwd_f32": 1, "rollout_bwd_f32": 1}, step_limit, "tasks (a) K6", cap)
    out["dp_k6_step_ms"] = 1e3 * sec / step_limit
    rows.update({f"{k}/dp": delta[k] for k in rc.launches})
    loop.use_fused_rollout, loop.use_fused_paths = False, True
    loop.policy_spec = dataclasses.replace(loop.policy_spec, step_limit=TASK_K1_STEPS)
    _, delta, cap, sec = counted_update(loop, counters, "tasks (a) update through K1")
    expect(delta, {"path_eval_fwd": DP_T, "path_eval_bwd_dx": DP_T}, TASK_K1_STEPS, "tasks (a) K1", cap)
    out["dp_k1_step_ms"] = 1e3 * sec / TASK_K1_STEPS
    rows.update({f"{k}/dp": delta[k] for k in pe.launches})
    loop.use_fused_rollout = True
    t0 = time.perf_counter()
    ep = loop.step()
    sync()
    out["dp_episode_s"] = time.perf_counter() - t0
    print(f"tasks (a): RK4 episode {out['dp_episode_s']:.2f} s, reward {ep.metrics['rewards']:.4f}, "
          f"model-predicted {ep.metrics['eReward']:.4f}, success {ep.metrics['success']}")
    assert ep.states.shape == (DP_T + 1, 4) and np.isfinite(ep.states).all()
    assert np.all(np.abs(ep.actions) <= 2.0) and math.isfinite(ep.metrics["eReward"])
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    with torch.no_grad():
        paths = generate_paths_svgp(drift, gen, DP_S, DP_B)
        x0 = loop.episode_spec.sample(gen, (DP_S,), dtype=f32, device=device)
    loop64 = task_loop("double_pendulum", PathwisePILCO, seed, device, f64, lbfgs_iters)
    loop64.use_fused_rollout = True
    out["dp_f64_rel_gap"], out["dp_f64_noise"], out["dp_f64_grad_cos"], _ = f64_rollout_hold(
        "tasks (a)", loop64, copy.deepcopy(loop.policy_model).double(), copy.deepcopy(drift).double(),
        PathState(*(p.double() for p in paths)), x0.double())

    # ---- (b) double pendulum, MM, on (a)'s episodes and drift
    mm = task_loop("double_pendulum", MomentMatchingPILCO, seed, device, f32, lbfgs_iters,
                   step_limit=TASK_MM_STEPS, loss_dtype=f64)
    mm.episodes, mm.drift_model = loop.episodes, drift
    mm.policy_model = mm.build_policy()
    mm.use_fused_mm = True
    _, delta, cap, sec = counted_update(mm, counters, "tasks (b) use_fused_mm update, float64 loss")
    expect(delta, {"pair_contract_fwd_f64": DP_T, "pair_contract_bwd_frozen_f64": DP_T,
                   "pair_contract_fwd_f32": DP_T, "pair_contract_bwd_f32": DP_T}, TASK_MM_STEPS,
           "tasks (b) K2", cap)
    out["dp_mm_step_ms"] = 1e3 * sec / TASK_MM_STEPS
    rows.update({f"{k}/dp": delta[k] for k in kc.launches})
    losses = mm_losses(mm)
    rel = abs(losses["kernel"] - losses["unfused"]) / abs(losses["unfused"])
    noise = mm_loss_noise(mm, losses["unfused"])
    bar = max(1e-9, 10.0 * noise)
    print(f"tasks (b): {DP_T}-step float64 MM loss via K2 {losses['kernel']:.15f}, unfused "
          f"{losses['unfused']:.15f}, relative gap {rel:.3e}; rounding noise {noise:.3e}, bar {bar:.3e}")
    assert math.isfinite(losses["kernel"]) and rel <= bar, "tasks (b): K2 and unfused MM losses disagree"
    out["dp_mm_f64_rel_gap"] = rel
    wm = task_loop("double_pendulum", MomentMatchingPILCO, seed, device, f32, lbfgs_iters,
                   step_limit=TASK_MM_STEPS)
    wm.episodes, wm.drift_model, wm.policy_model = loop.episodes, drift, mm.policy_model
    wm.use_fused_match = True
    assert wm._fused_match_on
    _, delta, cap, sec = counted_update(wm, counters, "tasks (b) use_fused_match update, float32")
    # as the whole-match slice counts them, at T = 50
    expect(delta, {"svgp_match_fwd_f32": 2 * DP_T, "svgp_match_bwd_frozen_f32": DP_T,
                   "svgp_match_bwd_f32": DP_T, "enc_match_fwd_f32": DP_T + 1, "enc_match_bwd_f32": DP_T,
                   "psd_boost_f32": DP_T, "euler_update_f32": DP_T}, TASK_MM_STEPS, "tasks (b) K3-K5", cap)
    out["dp_match_step_ms"] = 1e3 * sec / TASK_MM_STEPS
    rows.update({f"{k}/dp": delta[k] for c in (mc, ec, gc) for k in c.launches})
    with torch.no_grad():
        l_fused, states = whole_match_loss(wm, True, f64)
        l_unfused = float(whole_match_loss(wm, False, f64)[0])
        noise = max(abs(float(whole_match_loss(wm, False, f64, dx)[0]) - l_unfused) / abs(l_unfused)
                    for dx in (1e-14, 1e-13, 1e-12))
        sym = policy_joints(wm, initial_moments(wm, f64), states, f64)
        lam_j, lam_e = gc.jacobi_min_eig(sym), torch.linalg.eigvalsh(sym).amin(-1)
        gap = max(jacobi_gap, float(((lam_j - lam_e).abs() / (1.0 + sym.abs().amax(dim=(-2, -1)))).max()))
    rel = abs(float(l_fused) - l_unfused) / abs(l_unfused)
    bar = max(1e-9, 10.0 * noise, 10.0 * gap)
    print(f"tasks (b): {DP_T}-step float64 loss, whole-match kernels {float(l_fused):.15f}, unfused "
          f"{l_unfused:.15f}, relative gap {rel:.3e}; rounding noise {noise:.3e}, Jacobi gap {gap:.3e} "
          f"(policy joints D={sym.shape[-1]}), bar {bar:.3e}")
    assert math.isfinite(float(l_fused)) and rel <= bar, "tasks (b): whole-match and unfused losses disagree"
    out["dp_match_f64_rel_gap"] = rel

    # ---- (c) mountain car, full width
    car = task_loop("mountain_car", MomentMatchingPILCO, seed, device, f32, lbfgs_iters,
                    step_limit=TASK_MM_STEPS)
    assert car.episode_spec.num_steps == MC_T and car.encoder is None
    outer_loop(car, num_episodes=8, num_episodes_init=8, log_summaries=False)
    info_d = car.update_dynamics()
    car.policy_model = car.build_policy()
    print(f"tasks (c): mountain car, drift fit loss {info_d['loss']:.4f}, M={car.drift_model.num_inducing}, "
          f"policy M={car.policy_model.num_inducing}")
    assert math.isfinite(info_d["loss"]) and car.drift_model.num_inducing == MC_M
    assert car.policy_model.num_inducing == MC_MP
    car.use_fused_mm = True
    _, delta, cap, _ = counted_update(car, counters, "tasks (c) use_fused_mm update, float32 loss")
    expect(delta, {"pair_contract_fwd_f32": 2 * MC_T, "pair_contract_bwd_frozen_f32": MC_T,
                   "pair_contract_bwd_f32": MC_T}, TASK_MM_STEPS, "tasks (c) K2", cap)
    pw = task_loop("mountain_car", PathwisePILCO, seed, device, f32, lbfgs_iters, step_limit=TASK_K1_STEPS)
    pw.episodes, pw.drift_model, pw.policy_model = car.episodes, car.drift_model, car.policy_model
    pw.use_fused_paths = pw.use_fused_rollout = True
    assert not pw._fused_rollout_eligible(pw.drift_model, pw.policy_model)  # no encoder
    _, delta, cap, _ = counted_update(pw, counters, "tasks (c) pathwise update through K1")
    expect(delta, {"path_eval_fwd": MC_T, "path_eval_bwd_dx": MC_T}, TASK_K1_STEPS, "tasks (c) K1", cap)
    rows.update({f"{k}/mc": delta[k] for k in pe.launches})
    ep = car.step()
    sync()
    print(f"tasks (c): RK4 episode, reward {ep.metrics['rewards']:.4f}, model-predicted "
          f"{ep.metrics['eReward']:.4f}")
    assert ep.states.shape == (MC_T + 1, 2) and np.isfinite(ep.states).all()
    assert np.all(np.abs(ep.actions) <= 4.0) and math.isfinite(ep.metrics["eReward"])

    # ---- (d) the new drift fits on (a)'s data, against L-BFGS's ELBO
    x, y = loop.get_data_dynamics()
    with torch.no_grad():
        elbos = {"lbfgs": float(svgp_elbo(drift, x, y))}
    secs = {"lbfgs": out["dp_lbfgs_s"]}
    for name in ("adam", "natgrad_adam"):
        loop.drift_spec = dataclasses.replace(loop.drift_spec, optimizer=name, max_iters=lbfgs_iters)
        t0 = time.perf_counter()
        info = loop.update_dynamics()
        sync()
        secs[name] = time.perf_counter() - t0
        with torch.no_grad():
            elbos[name] = float(svgp_elbo(loop.drift_model, x, y))
        assert math.isfinite(info["loss"]) and math.isfinite(elbos[name]), f"tasks (d): {name} fit {info}"
    print(f"tasks (d): double-pendulum drift fits on N={x.shape[0]} at M={DP_M}, {lbfgs_iters} iterations "
          f"(natgrad_adam: {max(1, lbfgs_iters // 10)} rounds): ELBO " +
          ", ".join(f"{k} {v:.3f} ({secs[k]:.2f} s)" for k, v in elbos.items()))
    out.update({f"elbo_{k}": v for k, v in elbos.items()}, **{f"fit_{k}_s": v for k, v in secs.items()})
    return rows, out


# kernel-name fragments whose rows a profile prints on their own: this
# repository's kernels and the eigenvalue solver behind psd_project's eigvalsh
_WATCHED = ("fwd_warp", "bwd_warp", "bwd_full_warp", "bwd_jac", "bwd_maps", "bwd_adjoint", "bwd_grads",
            "bwd_finish", "fwd_finish", "bwd_groups", "bwd_slots", "fwd_tiles", "bwd_tiles",
            "combine", "enc_fwd", "enc_bwd", "psd_kernel", "euler_warp", "euler_kernel", "syev", "eig")
# host runtime calls that wait for the device or copy through it
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def _profile(name, fn, out_dir, reps=3, export=True):
    """Wall time, device busy share, top kernels, the watched kernels and the
    host's synchronizing runtime calls, of ``fn`` (torch.profiler); with
    ``export``, its Chrome trace into ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall = time.perf_counter() - t0
    if export:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(out_dir) / f"{name}_trace.json"))
    # device-side events only: operator rows repeat their kernels' time
    kernels = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))  # noqa: E731
    busy_us = sum(dev(e) for e in kernels)
    events = sum(e.count for e in kernels)
    print(f"profile {name}: wall {1e3 * wall / reps:.2f} ms per call, device busy "
          f"{busy_us / 1e3 / reps:.2f} ms ({100 * busy_us / 1e6 / wall:.1f}% of wall), "
          f"{events // reps} device events per call")
    for e in sorted(kernels, key=dev, reverse=True)[:8]:
        print(f"  {dev(e) / 1e3 / reps:8.3f} ms  {e.count // reps:6d} calls  {e.key[:90]}")
    for e in sorted(kernels, key=dev, reverse=True):
        if any(w in e.key for w in _WATCHED):
            print(f"  watched {dev(e) / 1e3 / reps:8.3f} ms  {e.count // reps:6d} calls  {e.key[:90]}")
    host = [e for e in prof.key_averages() if any(e.key.startswith(w) for w in _SYNCS)]
    print("  host syncs and copies per call: " + (", ".join(
        f"{e.key} x{e.count // reps}" for e in host) or "none"))


def profile_phase(loop, mm_loop, match_loop, ens_loop, out_dir):
    """Profiles of one pathwise (the K1 path and the fused rollout), one MM,
    one whole-match MM and one whole-match ensemble MM policy loss+grad
    evaluation and one drift ELBO+grad evaluation, at the slices' shapes."""
    from gpflowpilco_torch.models.builders import dynamics_mask
    from gpflowpilco_torch.models.gp import svgp_elbo
    from gpflowpilco_torch.models.priors import pilco_snr_penalty

    model, drift = loop.policy_model, loop.policy_loss_drift()
    gen = loop.iteration_generator(99)
    loop.use_fused_rollout = False
    _profile("policy_step", lambda: loop.policy_loss_fn(model, gen, drift=drift).backward(), out_dir)
    loop.use_fused_rollout = True
    _profile("fused_rollout_policy_step",
             lambda: loop.policy_loss_fn(model, gen, drift=drift).backward(), out_dir)
    mm_model, mm_drift = mm_loop.policy_model, mm_loop.policy_loss_drift()
    # ~33k device events per call: too large a trace to keep
    _profile(
        "mm_policy_step",
        lambda: mm_loop.policy_loss_fn(mm_model, None, drift=mm_drift).backward(),
        out_dir, export=False,
    )
    match_model, match_drift = match_loop.policy_model, match_loop.policy_loss_drift()
    _profile(
        "match_policy_step",
        lambda: match_loop.policy_loss_fn(match_model, None, drift=match_drift).backward(),
        out_dir, export=False,
    )

    ens_loop.use_fused_mm, ens_loop.use_fused_match = False, True
    ens_loop.policy_spec = dataclasses.replace(ens_loop.policy_spec, loss_dtype=None)
    ens_model, ens_drift = ens_loop.policy_model, ens_loop.policy_loss_drift()
    _profile(
        "ensemble_match_policy_step",
        lambda: ens_loop.policy_loss_fn(ens_model, None, drift=ens_drift).backward(),
        out_dir, export=False,
    )

    x, y = loop.get_data_dynamics()
    dynamics_mask(drift, freeze_inducing=drift.num_inducing >= x.shape[0])
    _profile(
        "drift_elbo",
        lambda: (-(svgp_elbo(drift, x, y) + pilco_snr_penalty(drift))).backward(),
        out_dir,
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--step-limit", type=int, default=50)
    p.add_argument("--lbfgs-iters", type=int, default=100)
    p.add_argument("--profile", default=None, help="directory for a policy-step trace")
    args = p.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent
    sys.path[:0] = [str(root), str(root / "examples" / "cartpole_swingup")]
    from gpflowpilco_torch.ops import _build
    from gpflowpilco_torch.ops import enc_match_cuda as ec
    from gpflowpilco_torch.ops import gpr_match_cuda as gm
    from gpflowpilco_torch.ops import kexp_cuda as kc
    from gpflowpilco_torch.ops import mm_glue_cuda as gc
    from gpflowpilco_torch.ops import mm_match_cuda as mc
    from gpflowpilco_torch.ops import path_eval_cuda as pe
    from gpflowpilco_torch.ops import rollout_cuda as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items()) or 'cached'})")

    phase_s = {"build": time.perf_counter() - t0}
    # ptxas: every kernel's registers, spills and stack frame; a gated float32
    # kernel at the main path's register capacity or shape must not spill
    # (K4's kernels and K5b's must not touch local memory at all)
    for lib, kernels, gated, caps, no_stack in PTXAS_LIBS:
        regs = ptxas_report(_build.compiler_output.get(lib, ""), kernels)
        for kern, t, params, n_regs, st, ld, stack in regs:
            targs = "".join(f", {v}" for v in params)
            print(f"ptxas {lib} {kern}<{'float' if t == 'f' else 'double'}{targs}>: {n_regs} registers, "
                  f"{st} bytes spill stores, {ld} bytes spill loads, {stack} bytes stack frame")
        bad = [r for r in regs if r[0] in gated and r[1] == "f" and r[2] and r[2][0] in caps
               and r[4] + r[5] + (r[6] if no_stack else 0)]
        if built.get(lib) is not None and (not regs or bad):
            raise AssertionError(f"{lib}'s gated float32 kernels at {caps} spill"
                                 f"{' or use a stack frame' if no_stack else ''}, or were not reported: "
                                 f"{bad or regs}")

    def timed(name, fn, *fn_args):
        t_phase = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t_phase
        return out

    errs, timings = timed("K1", kernels_phase, pe, args.seed, device)
    pair_errs, pair_timings = timed("K2", pair_kernels_phase, kc, args.seed, device)
    match_errs, match_timings, jacobi_gap = timed("K3-K5", match_kernels_phase, mc, ec, gc, args.seed, device)
    gpr_errs, gpr_timings = timed("K3g", gpr_kernels_phase, gm, kc, args.seed, device)
    roll_errs, roll_timings, _ = timed("K6", rollout_kernels_phase, rc, args.seed, device)
    loop, launches, slice_ms = timed("pathwise", slice_phase, pe, args.seed, device, args.step_limit,
                                     args.lbfgs_iters)
    f64_launches, f64_ms = timed("pathwise f64", f64_paths_phase, pe, loop, args.seed, device)
    roll_launches, fused_ms = timed("fused rollout", fused_rollout_slice_phase, rc, pe, loop, args.seed,
                                    device, args.step_limit)
    _, policy_loop_ms = timed("policy loop", policy_loop_phase, rc, pe, loop, args.seed, device,
                              args.step_limit)
    scale_ms = timed("scale-out", scaleout_phase, rc, pe, loop, args.seed, device)
    mm_loop, pair_launches, mm_ms = timed("mm", mm_slice_phase, kc, args.seed, device, args.step_limit,
                                          args.lbfgs_iters)
    counters = (pe, kc, mc, ec, gc, rc)
    match_loop, match_launches, match_ms = timed(
        "whole match", match_slice_phase, counters, args.seed, device, args.step_limit, args.lbfgs_iters,
        jacobi_gap)
    ens_loop, _, ens_launches_a, ens_launches_b, ens_ms = timed(
        "ensemble", ensemble_slice_phase, (*counters, gm), args.seed, device, args.step_limit,
        args.lbfgs_iters)
    # slice D: the kernels at the double pendulum's (and K1 at mountain car's) shapes, then the tasks
    dp_errs, dp_timings = timed("K1 dp", kernels_phase, pe, args.seed, device, DP_PATHS, "/dp", False)
    dp_match = timed("K3-K5 dp", match_kernels_phase, mc, ec, gc, args.seed, device, DP_MATCH_SHAPES,
                     (DP_ACTIVE, 4), DP_DE + DP_U, DP_T, "/dp")
    dp_gap = dp_match[2]  # Jacobi's lambda_min gap at the policy joint's D = 8
    # (K6's operands from seed + 100, apart from the cartpole widths')
    dp_roll = timed("K6 dp", rollout_kernels_phase, rc, args.seed + 100, device, DP_ROLL_WIDTHS, "/dp")
    for e, t in (timed("K1 mc", kernels_phase, pe, args.seed, device, MC_PATHS, "/mc", False),
                 timed("K2 dp", pair_kernels_phase, kc, args.seed, device, DP_PAIR_SHAPES, "/dp"),
                 dp_match[:2], dp_roll[:2]):
        dp_errs.update(e)
        dp_timings.update(t)
    # K2's DM = 32 instantiations, which the drift's D2 = 18 takes
    for kern, t, params, n_regs, st, ld, stack in ptxas_report(_build.compiler_output.get("kexp_pair", ""),
                                                               PTXAS_K2):
        if params and params[0] == 32:
            print(f"ptxas kexp_pair {kern}<{'float' if t == 'f' else 'double'}"
                  f"{''.join(f', {v}' for v in params)}> (the DM = 32 route): {n_regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads, {stack} bytes stack frame")
    task_launches, task_s = timed("tasks", tasks_phase, counters, args.seed, device, args.step_limit,
                                  args.lbfgs_iters, dp_gap)
    if args.profile:
        timed("profile", profile_phase, loop, mm_loop, match_loop, ens_loop, args.profile)

    for name, n in launches.items():
        if name in ("path_eval_fwd", "path_eval_bwd_dx") and n == 0:
            raise AssertionError(f"{name} was not launched on the pathwise path")
    launches.update(f64_launches)  # the float64 rows' launches: the float64 K1 hold's
    for name, n in match_launches.items():
        if name in pe.launches or name in kc.launches or name in rc.launches:
            continue
        launches[name] = n
    errs.update(pair_errs)
    errs.update(match_errs)
    errs.update(gpr_errs)
    errs.update(roll_errs)
    timings.update(pair_timings)
    timings.update(match_timings)
    timings.update(gpr_timings)
    timings.update(roll_timings)
    launches.update(pair_launches)
    launches.update(roll_launches)
    # slice B: K3g's launches from (a); K2's GPR route's from (b), whose
    # float64 entries are the drift's alone (its float32 ones are the SVGP
    # policy island's), so the GPR route's float32 rows count none
    launches.update({k: v for k, v in ens_launches_a.items() if k in gm.launches})
    launches.update({f"{k}/gpr": ens_launches_b[k] if k.endswith("_f64") else 0 for k in kc.launches})
    sources = dict.fromkeys(pe.launches, "gpflowpilco_torch/csrc/path_eval.cu")
    sources.update(dict.fromkeys(kc.launches, "gpflowpilco_torch/csrc/kexp_pair.cu"))
    sources.update(dict.fromkeys(mc.launches, "gpflowpilco_torch/csrc/mm_match.cu"))
    sources.update(dict.fromkeys(ec.launches, "gpflowpilco_torch/csrc/enc_match.cu"))
    sources.update(dict.fromkeys(gc.launches, "gpflowpilco_torch/csrc/mm_glue.cu"))
    sources.update(dict.fromkeys(gm.launches, "gpflowpilco_torch/csrc/gpr_match.cu"))
    sources.update(dict.fromkeys(rc.launches, "gpflowpilco_torch/csrc/rollout.cu"))
    k1_sites = {"path_eval_fwd": "58", "path_eval_bwd_dx": "102", "path_eval_bwd_full": "90"}
    replaces = {name: "gpflowpilco_tpu/ops/path_eval_pallas.py:" + k1_sites[name.removesuffix("_f64")]
                for name in pe.launches}
    for name in kc.launches:
        replaces[name] = "gpflowpilco_tpu/ops/kexp_pallas.py:" + ("47" if "_fwd_" in name else "62")
    for name in gm.launches:
        replaces[name] = "gpflowpilco_tpu/ops/mm_match_pallas.py:" + ("1120" if "_fwd_" in name else "1133")
    for name in mc.launches:
        replaces[name] = "gpflowpilco_tpu/ops/mm_match_pallas.py:" + (
            "624" if "_fwd_" in name else "637" if "frozen" in name else "657")
    for name in ec.launches:
        replaces[name] = "gpflowpilco_tpu/ops/enc_match_pallas.py:" + ("252" if "_fwd_" in name else "262")
    for name in gc.launches:
        replaces[name] = "gpflowpilco_tpu/ops/mm_glue_pallas.py:" + ("87" if "psd" in name else "130")
    for name in rc.launches:
        replaces[name] = "gpflowpilco_tpu/ops/rollout_pallas.py:" + ("195" if "_fwd_" in name else "221")
    # K2's GPR-route rows: the same kernel entries at the GPR grid's shape
    gpr_route = [f"{k}/gpr" for k in kc.launches if f"{k}/gpr" in timings]
    for name in gpr_route:
        base = name.split("/")[0]
        sources[name], replaces[name] = sources[base], replaces[base]
    # slice D's rows: each kernel at the double pendulum's shapes (K1 also at
    # mountain car's), its launches from the tasks phase's runs
    k1_task = ("path_eval_fwd", "path_eval_bwd_dx", "path_eval_fwd_f64", "path_eval_bwd_dx_f64")
    task_rows = [f"{k}/{t}" for t in ("dp", "mc") for k in k1_task] + [
        f"{k}/dp" for c in (kc, mc, ec, gc, rc) for k in c.launches]
    for name in task_rows:
        base = name.split("/")[0]
        sources[name], replaces[name] = sources[base], replaces[base]
    errs.update(dp_errs)
    timings.update(dp_timings)
    launches.update({name: task_launches[name] for name in task_rows})
    names = (*pe.launches, *kc.launches, *gpr_route, *mc.launches, *ec.launches, *gc.launches,
             *gm.launches, *rc.launches, *task_rows)
    for name in names:
        timings[name].setdefault("library_ms", None)
    kernels = [
        dict(
            name=name,
            route="cuda",
            source=sources[name],
            replaces=replaces[name],
            launches=launches[name],
            max_abs_err=errs[name],
            ms=timings[name]["ms"],
            plain_ms=timings[name]["plain_ms"],
            # "device": CUDA-event time with the device held busy; "wall": host
            # wall time of one call, for plain versions that wait for the device
            plain_how=timings[name]["plain_how"],
            bound_ms=timings[name]["bound_ms"],
            bound_by=timings[name]["bound_by"],
            library_ms=timings[name]["library_ms"],
        )
        for name in names
    ]
    print(f"pathwise slice ms: {json.dumps(slice_ms)}")
    print(f"pathwise f64 (K1 in float64): {json.dumps(f64_ms)}")
    print(f"fused-rollout slice: {json.dumps(fused_ms)} (K1 path {slice_ms['policy_step_ms']:.2f} ms "
          f"per policy step in this call)")
    print(f"policy loop: {json.dumps(policy_loop_ms)}")
    print(f"scale-out: {json.dumps(scale_ms)}")
    print(f"mm slice ms: {json.dumps(mm_ms)}")
    print(f"whole-match slice ms: {json.dumps(match_ms)}")
    print(f"ensemble slice: {json.dumps(ens_ms)}")
    print(f"tasks: {json.dumps(task_s)}; K6's forward at the double pendulum's widths: "
          f"{json.dumps(dp_roll[2])}")
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}, total "
          f"{time.perf_counter() - t_start:.1f}")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
