#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (gpflowpilco_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--step-limit 50] [--lbfgs-iters 100] [--profile DIR]

1. Refuses to run without CUDA; prints the card's name and power limit.
2. Builds every CUDA kernel from the sources in this checkout (one nvcc per
   source, all started together) and prints the build time.
3. Kernels: at the main path's shapes (S=1024 particles, L=4 latents,
   B=1024 Fourier bases, M=240 inducing points, D=6 inputs, float32, inputs
   made from --seed with numpy) runs each kernel on the card, holds it
   against its plain torch version on the same inputs, and times both.
4. Slice: pathwise PILCO on cartpole at full width (1024 particles x 1024
   bases, horizon 30, up to 240 inducing points): 8 random episodes through
   outer_loop, then one iteration (L-BFGS drift fit, Adam policy update, one
   RK4 episode). The kernels' launch counts are zeroed just before that
   iteration and read just after; each kernel the path runs must have run.
5. Prints the kernels' JSON line, then {"ok": true, "device": {...}} as the
   last line. Any failed check raises, so the exit code is non-zero.

Tolerance of the kernel checks: rtol = atol = 1e-4. The kernel and its plain
version both sum ~1024 float32 terms of size ~0.05 per output, in different
orders and with differently rounded cos/sin/exp arguments; the expected gap
is ~1e-6, so 1e-4 leaves room without hiding a wrong index or term.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def sync():
    torch.cuda.synchronize()


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


def bound_ms(kind):
    """Least time one launch could take on an H100 SXM at 700 W: the bytes it
    must move (each input read once, each output written once) over 3.35 TB/s,
    or its float32 operations over 67 TFLOP/s, whichever is larger. Returns
    (ms, 'bytes' | 'operations')."""
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
    t_bytes = (inputs + outputs) * 4 / 3.35e12
    t_ops = flops / 67e12
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_inputs(seed, device):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()  # noqa: E731
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


def check(name, got, want):
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=RTOL, atol=ATOL)
    print(f"  {name}: max|kernel - plain| = {err:.3e}  ({'ok' if ok else 'FAILED'})")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max err {err})")
    return err


def kernels_phase(pe, seed, device):
    """Hold K1a/K1b/K1c against the plain version and time both."""
    t = kernel_inputs(seed, device)
    ops = (t["x"], t["w"], t["v"], t["omega"], t["phase"], t["z_scaled"], t["z2"], t["inv_ls"])
    g = t["g"]
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)  # > 50 MB L2

    want_f = pe.path_eval_reference(*ops)
    want_dx, _, _ = pe.path_eval_reference_bwd(*ops, g, want_wv=False)
    _, want_dw, want_dv = pe.path_eval_reference_bwd(*ops, g, want_wv=True)
    got_f = pe._fwd(*ops)
    got_dx = pe._bwd_dx(*ops, g)
    full_dx, got_dw, got_dv = pe._bwd_full(*ops, g)
    sync()
    print(f"kernels at S={S} L={L} B={B} M={M} D={D} float32, rtol=atol={RTOL}:")
    errs = {
        "path_eval_fwd": check("path_eval_fwd f", got_f, want_f),
        "path_eval_bwd_dx": check("path_eval_bwd_dx dx", got_dx, want_dx),
        "path_eval_bwd_full": max(
            check("path_eval_bwd_full dx", full_dx, want_dx),
            check("path_eval_bwd_full dw", got_dw, want_dw),
            check("path_eval_bwd_full dv", got_dv, want_dv),
        ),
    }
    calls = {
        "path_eval_fwd": (
            lambda: pe._fwd(*ops),
            lambda: pe.path_eval_reference(*ops),
            "fwd",
        ),
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
    timings = {}
    for name, (kern, plain, kind) in calls.items():
        ms = median_ms(kern, flush=flush)
        warm_ms = median_ms(kern)
        plain_ms = median_ms(plain, reps=10, flush=flush)
        bound, bound_by = bound_ms(kind)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        print(
            f"  {name}: {ms:.4f} ms cold-L2 median ({warm_ms:.4f} ms warm), "
            f"plain torch {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})"
        )
    return errs, timings


def slice_phase(pe, seed, device, step_limit, lbfgs_iters):
    """8 random episodes, then one full-width pathwise PILCO iteration."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples" / "cartpole_swingup"))
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


def _profile(name, fn, out_dir, reps=3):
    """Wall time, device busy share and top kernels of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall = time.perf_counter() - t0
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


def profile_phase(loop, out_dir):
    """Profiles of one policy loss+grad evaluation and one drift ELBO+grad
    evaluation, at the slice's shapes."""
    from gpflowpilco_torch.models.builders import dynamics_mask
    from gpflowpilco_torch.models.gp import svgp_elbo
    from gpflowpilco_torch.models.priors import pilco_snr_penalty

    model, drift = loop.policy_model, loop.policy_loss_drift()
    gen = loop.iteration_generator(99)
    _profile("policy_step", lambda: loop.policy_loss_fn(model, gen, drift=drift).backward(), out_dir)

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
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from gpflowpilco_torch.ops import _build
    from gpflowpilco_torch.ops import path_eval_cuda as pe

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

    errs, timings = kernels_phase(pe, args.seed, device)
    loop, launches, slice_ms = slice_phase(pe, args.seed, device, args.step_limit, args.lbfgs_iters)
    if args.profile:
        profile_phase(loop, args.profile)

    for name, n in launches.items():
        if name != "path_eval_bwd_full" and n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    replaces = {
        "path_eval_fwd": "gpflowpilco_tpu/ops/path_eval_pallas.py:58",
        "path_eval_bwd_dx": "gpflowpilco_tpu/ops/path_eval_pallas.py:102",
        "path_eval_bwd_full": "gpflowpilco_tpu/ops/path_eval_pallas.py:90",
    }
    kernels = [
        dict(
            name=name,
            route="cuda",
            source="gpflowpilco_torch/csrc/path_eval.cu",
            replaces=replaces[name],
            launches=launches[name],
            max_abs_err=errs[name],
            ms=timings[name]["ms"],
            plain_ms=timings[name]["plain_ms"],
            bound_ms=timings[name]["bound_ms"],
            bound_by=timings[name]["bound_by"],
            library_ms=None,
        )
        for name in ("path_eval_fwd", "path_eval_bwd_dx", "path_eval_bwd_full")
    ]
    print(f"slice ms: {json.dumps(slice_ms)}")
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
