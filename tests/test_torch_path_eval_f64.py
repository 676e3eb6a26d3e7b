"""The path-eval kernel op's float64 route and its full backward (K1c) on
the CPU, held against the plain version and the JAX package.

The CUDA kernels run only on the card (tests/test_torch_gpu.py); here:
the float64 chunk plan against csrc/path_eval.cu's constants, K1c's lane
partition and sum order restated in torch (its dx bit for bit K1b's), the
float64 sin/cos restated in numpy, the wrapper's type check, and a float64
PathwisePILCO loss and policy gradient under use_fused_paths against the
JAX package's with its Pallas kernel in interpret mode.
"""
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.loops.pilco import PathwisePILCO as JaxPathwisePILCO
from gpflowpilco_tpu.loops.pilco import PolicySpec as JaxPolicySpec
from gpflowpilco_tpu.models.pathwise import generate_paths_svgp as jax_generate_paths
from gpflowpilco_torch.convert import paths_from_numpy, svgp_from_numpy
from gpflowpilco_torch.loops import pilco
from gpflowpilco_torch.loops.pilco import PathwisePILCO, PolicySpec
from gpflowpilco_torch.models.builders import policy_mask
from gpflowpilco_torch.ops import path_eval_cuda as pe

from ._torch_export import CPU, jax_svgp, paths_to_numpy, svgp_to_numpy, t
from .test_torch_path_eval import _backward_warp_split

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
import experiment as jax_experiment  # noqa: E402
import run_torch  # noqa: E402

torch.set_num_threads(1)
CSRC = pathlib.Path(pe.__file__).resolve().parents[1] / "csrc" / "path_eval.cu"


def _cu_constants():
    """kRing, kRingBytes, kSmemMax and each type's particles a block (kTP)
    as csrc/path_eval.cu states them."""
    src = CSRC.read_text()
    num = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))  # noqa: E731
    tp = dict(re.findall(r"struct Cfg<(float|double)> \{\s*static constexpr int kTP = (\d+);", src))
    return num("kRing"), num("kRingBytes"), num("kSmemMax"), {k: int(v) for k, v in tp.items()}


@pytest.mark.parametrize("b, m, d, chunks", [(1024, 240, 6, 1), (1024, 320, 8, 1), (2500, 12, 16, 3)])
def test_torch_path_eval_forward_plan_f64(b, m, d, chunks):
    """fwd_plan for float64 at the path's shapes (the cartpole's 1024 + 240
    columns at D = 6, the double pendulum's 1024 + 320 at D = 8) and where
    the columns outgrow shared memory (2500 + 12 at D = 16): the chunk is a
    multiple of 128, the bytes at most FWD_SMEM_MAX, one chunk at the path's
    widths; and the wrapper's ring and cap are the .cu's: kRing groups of 4
    values a thread, 64 KB in both types (1024 float32 threads a block, 512
    float64)."""
    ring, ring_bytes, smem_max, tp = _cu_constants()
    assert pe.FWD_RING_BYTES == ring_bytes and pe.FWD_SMEM_MAX == smem_max
    assert ring * 4 * 4 * 32 * tp["float"] == ring * 4 * 8 * 32 * tp["double"] == ring_bytes
    cw, nbytes = pe.fwd_plan(b, m, d, 8)
    cols = -(-b // 4) * 4 + -(-m // 4) * 4
    assert cw % 128 == 0 and 0 < nbytes <= pe.FWD_SMEM_MAX
    assert nbytes == ring_bytes + 8 * (d + 1) * cw and -(-cols // cw) == chunks
    assert nbytes + 8 * (d + 1) * 128 > pe.FWD_SMEM_MAX or cw >= cols
    assert cw * d < 2**16  # stage_panels' division by D is exact below 2^16
    assert pe.fwd_plan(b, m, d) == pe.fwd_plan(b, m, d, 4)


def _backward_full_split(x, w, v, omega, phase, z_scaled, z2, inv_ls, g):
    """The order of csrc/path_eval.cu's full backward (K1c), in torch: K1b's
    lane partition and sum order for dx (_backward_warp_split's), and from
    each group's proj and -d2/2, computed once, the group's dw = cos(proj) g
    and dv = exp(-d2 / 2) g written at their columns, the pads dropped.
    Returns dx (S, D), dw (S, L, B), dv (S, L, M)."""
    proj, xs, k = pe._proj_and_k(x, omega, phase, z_scaled, z2, inv_ls)
    pad = lambda a, dim=-1: torch.nn.functional.pad(  # noqa: E731
        a, (0, 0) * (-1 - dim) + (0, -a.shape[dim] % 4))
    coef = torch.cat([pad(-torch.sin(proj) * w), pad(k * v)], dim=-1)  # (S, L, cols)
    outs = torch.cat([pad(torch.cos(proj) * g[..., None]), pad(k * g[..., None])], dim=-1)
    rows = torch.cat([pad(omega, -2), pad(z_scaled * inv_ls[:, None, :], -2)], dim=-2)  # (L, cols, D)
    bw = coef.shape[-1] - pad(v).shape[-1]
    s, num_latent, cols = coef.shape
    b, m = w.shape[-1], v.shape[-1]
    lanes = torch.arange(32)
    acc = torch.zeros((s, num_latent, 32, x.shape[1]), dtype=x.dtype)
    kvsum = torch.zeros((s, num_latent, 32), dtype=x.dtype)
    written = torch.full((s, num_latent, cols), float("nan"), dtype=x.dtype)
    for item in range(-(-cols // 128)):
        for q in range(4):
            col = 4 * (lanes + 32 * item) + q
            live = col < cols
            col = torch.where(live, col, 0)
            c = torch.where(live, coef[..., col], 0.0)  # (S, L, 32)
            acc = acc + c[..., None] * rows[:, col, :]
            kvsum = torch.where(col < bw, kvsum, kvsum + c)
            written[..., col[live]] = outs[..., col[live]]
    for off in (16, 8, 4, 2, 1):
        acc, kvsum = acc + acc[:, :, lanes ^ off], kvsum + kvsum[..., lanes ^ off]
    part = g[..., None] * (acc[:, :, 0] - kvsum[..., 0, None] * xs * inv_ls)  # (S, L, D)
    dx = part[:, 0]
    for l in range(1, num_latent):
        dx = dx + part[:, l]
    return dx, written[..., :b], written[..., bw:bw + m]


@pytest.mark.parametrize("b, m, d", [(1024, 240, 6), (1000, 239, 6), (70, 19, 12), (9, 3, 16)])
def test_torch_path_eval_full_backward_split_matches_reference(b, m, d):
    """K1c's partition (K1b's grid, groups of 4 columns a lane, the latents'
    partials added in order) and its dw and dv written from each group's
    proj and -d2/2, against path_eval_reference_bwd(want_wv=True) in
    float64, each output to 1e-12 of its scale, every column written once;
    and its dx bit for bit K1b's (_backward_warp_split): the two share the
    grid, the partition, the order and the sin. The shapes of K1b's split
    test: the path's B = 1024, M = 240, B and M not multiples of 4 or 32,
    and below one round of 32 groups."""
    rng = np.random.default_rng(b + m + d)
    s, num_latent = 8, 4
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float64)  # noqa: E731
    z = f(num_latent, m, d)
    ops = (f(s, d), 0.05 * f(s, num_latent, b), 0.1 * f(s, num_latent, m), f(num_latent, b, d),
           f(num_latent, b), z, (z * z).sum(-1), f(num_latent, d).abs() + 0.5)
    g = f(s, num_latent)
    got = _backward_full_split(*ops, g)
    want = pe.path_eval_reference_bwd(*ops, g, want_wv=True)
    for a, wnt, name in zip(got, want, ("dx", "dw", "dv")):
        assert a.shape == wnt.shape and bool(torch.isfinite(a).all()), name
        assert float((a - wnt).abs().max()) <= 1e-12 * float(wnt.abs().max()), name
    assert torch.equal(got[0], _backward_warp_split(*ops, g))


def _fma(a, b, c):
    """a b + c with one rounding, as the card's fma: a b exactly by
    Veltkamp's split (TwoProduct), then its sum with c (TwoSum) and the two
    rounding errors."""
    def split(v):
        t = 134217729.0 * v  # 2^27 + 1
        hi = t - (t - v)
        return hi, v - hi

    p = a * b
    (ah, al), (bh, bl) = split(a), split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    return s + (e + err)


def _sin_cos_f64(x):
    """csrc/path_eval.cu's float64 sin_cos_fast in numpy: x = k pi/2 + r by
    two-part Cody-Waite with FMAs, Taylor polynomials of sin r and cos r to
    r^17 by FMA (Horner), the quadrant's pick and signs."""
    k = np.rint(x * 0.63661977236758134)
    r = _fma(k, -6.123233995736766e-17, _fma(k, -1.5707963267948966, x))
    r2 = r * r
    fact = lambda n: float(np.prod(np.arange(1, n + 1)))  # noqa: E731
    ps, pc = np.full_like(r, 1 / fact(17)), np.full_like(r, 1 / fact(16))
    for i in range(7, 0, -1):  # ps: 1/17! .. 1/3!, then 1; pc: 1/16! .. 1/2!, then 1
        ps = _fma(ps, r2, (-1) ** i / fact(2 * i + 1))
        pc = _fma(pc, r2, (-1) ** i / fact(2 * i))
    ps, pc = _fma(ps, r2, np.ones_like(r)), _fma(pc, r2, np.ones_like(r))
    q = k.astype(np.int64)
    sr = r * ps
    sv, cv = np.where(q & 1, pc, sr), np.where(q & 1, sr, pc)
    return np.where(q & 2, -sv, sv), np.where((q + 1) & 2, -cv, cv)


def test_torch_path_eval_sin_cos_f64_matches_numpy():
    """The float64 kernels' sin and cos (one reduction for both) against
    numpy's over the path's arguments (|x| <= 100), at the quadrant edges
    and over the whole fast range |x| <= 2^20: within 2.5e-16 absolute, about
    one rounding of a value near 1."""
    rng = np.random.default_rng(0)
    edges = np.pi / 2 * np.arange(-9, 10)
    for x in (np.concatenate([rng.uniform(-100, 100, 20000), edges, edges + 1e-9]),
              rng.uniform(-2.0**20, 2.0**20, 20000)):
        s, c = _sin_cos_f64(x)
        assert np.abs(s - np.sin(x)).max() <= 2.5e-16 and np.abs(c - np.cos(x)).max() <= 2.5e-16


def test_torch_path_eval_wrapper_checks_types():
    """The CUDA wrapper takes operands of one type, float32 or float64:
    mixed float32/float64 operands (or float16) raise TypeError before any
    launch; float64 operands of one type pass the type check and stop at the
    device check (these lie on the CPU)."""
    rng = np.random.default_rng(1)
    s, num_latent, b, m, d = 8, 2, 8, 4, 3
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float64)  # noqa: E731
    ops = (f(s, d), f(s, num_latent, b), f(s, num_latent, m), f(num_latent, b, d), f(num_latent, b),
           f(num_latent, m, d), f(num_latent, m), f(num_latent, d))
    out = torch.empty((s, num_latent), dtype=torch.float64)
    cw = pe.fwd_plan(b, m, d, 8)[0]
    pe.reset_launches()
    for i in (0, 1, 7):
        mixed = tuple(o.float() if j == i else o for j, o in enumerate(ops))
        with pytest.raises(TypeError, match="one type"):
            pe._launch("path_eval_fwd", mixed, (out,), cw)
    with pytest.raises(TypeError, match="one type"):
        pe._launch("path_eval_fwd", ops, (out.float(),), cw)
    with pytest.raises(TypeError, match="one type"):
        pe._launch("path_eval_fwd", tuple(o.half() for o in ops), (out.half(),), cw)
    with pytest.raises(TypeError, match="CUDA device"):
        pe._launch("path_eval_fwd", ops, (out,), cw)
    assert not any(pe.launches.values())
    assert set(pe.launches) == {f"{e}{k}" for e in pe.ENTRIES for k in ("", "_f64")}


def test_torch_pathwise_f64_fused_paths_match_jax_interpret(monkeypatch):
    """A float64 PathwisePILCO loss and policy gradient with use_fused_paths
    (K1's plain version here; K1a and K1b on the card) through
    policy_loss_fn, at S=16 particles, B=16 bases, a drift of M=6 centers
    and T=3 steps, at the same paths and x0 as the JAX package's float64
    pathwise loss draws from one key: against JAX's unfused loss (the same
    float64 function) the loss to 1e-9 relative and the gradient's cosine
    >= 1 - 1e-9; against JAX's with use_fused_paths, its Pallas kernel in
    interpret mode, whose dots round the projections to float32
    (preferred_element_type=float32, gpflowpilco_tpu/ops/path_eval_pallas.py:44
    and :49), the loss to 1e-5 relative and the cosine >= 1 - 1e-6 (the
    projections' float32 rounding, ~6e-8 of arguments of order 10, moves
    the loss by ~1e-6 relative at most)."""
    from jax.experimental.pallas import tpu as pltpu

    specs = dict(num_centers=5, batch_size=16, num_bases=16, num_restarts=1)
    jloop = jax_experiment.build_loop(JaxPathwisePILCO, None, seed=5, dtype=jnp.float64,
                                      policy_spec=JaxPolicySpec(**specs), horizon=0.3, validation_samples=0)
    tloop = run_torch.build_loop(5, CPU, torch.float64, policy_spec=PolicySpec(**specs), horizon=0.3)
    assert tloop.episode_spec.num_steps == jloop.episode_spec.num_steps == 3 and tloop.dtype == torch.float64
    jdrift = jax_svgp(40, num_latent=4, m=6, d=6)
    jpol = jax_svgp(43, num_latent=1, m=5, d=5)
    key = jax.random.PRNGKey(3)

    def jax_loss(ls, z, q_mu):
        kern = jpol.kernel.__class__(**{**jpol.kernel.__dict__, "raw_lengthscales": ls})
        pm = jpol.__class__(**{**jpol.__dict__, "kernel": kern, "z": z, "q_mu": q_mu})
        return jloop.policy_loss_fn(pm, key, drift=jdrift)

    want = {}
    for fused in (False, True):
        jloop.use_fused_paths = fused
        with pltpu.force_tpu_interpret_mode():
            loss, grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
                jpol.kernel.raw_lengthscales, jpol.z, jpol.q_mu)
        want[fused] = (float(loss), np.concatenate([np.asarray(a).ravel() for a in grads]))

    # the same paths and x0 as JAX's policy_loss_fn draws from the key
    k_paths, k_init = jax.random.split(key)
    paths = paths_from_numpy(paths_to_numpy(jax_generate_paths(jdrift, k_paths, 16, 16)), CPU, torch.float64)
    x0 = t(jloop.episode_spec.sample(k_init, (16,)))
    monkeypatch.setattr(pilco, "generate_paths_svgp", lambda *a, **k: paths)
    routes = []
    real = pilco.PathwiseSVGPTransform
    monkeypatch.setattr(pilco, "PathwiseSVGPTransform",
                        lambda model, paths, fused=False: (routes.append(fused), real(model, paths, fused))[1])
    tdrift = svgp_from_numpy(svgp_to_numpy(jdrift), CPU, torch.float64).requires_grad_(False)
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float64)
    policy_mask(tpol)
    tloop.use_fused_paths = True
    loss = tloop.policy_loss_fn(tpol, None, drift=tdrift, x0=x0)
    loss.backward()
    got_g = np.concatenate([p.grad.numpy().ravel() for p in (tpol.kernel.raw_lengthscales, tpol.z, tpol.q_mu)])
    assert routes == [True] and loss.dtype == torch.float64
    for fused, bar, cos_bar in ((False, 1e-9, 1e-9), (True, 1e-5, 1e-6)):
        want_l, want_g = want[fused]
        assert abs(float(loss) - want_l) <= bar * abs(want_l), (fused, float(loss), want_l)
        cos = float(got_g @ want_g / (np.linalg.norm(got_g) * np.linalg.norm(want_g)))
        assert cos >= 1 - cos_bar, (fused, cos)


@pytest.mark.parametrize("task", ["cartpole_swingup", "double_pendulum", "mountain_car"])
def test_torch_runner_f64_flag_gives_float64_loop(task):
    """--f64 runs the whole loop in float64, the JAX runners' default; the
    port's runners default to float32."""
    from ._torch_tasks import load_example

    run = load_example(task)
    small = ["--device", "cpu"] + (["--smoke"] if task != "cartpole_swingup" else
                                   ["--batch-size", "8", "--num-bases", "8", "--num-centers", "8"])
    loops = {}
    for flags in ([], ["--f64"]):
        args = run.parser().parse_args(small + flags)
        loop = run.loop_from_args(args) if task == "cartpole_swingup" else run.loop_from_args(args, 0)[0]
        loops[bool(flags)] = loop
    assert loops[False].dtype == torch.float32 and loops[True].dtype == torch.float64
    assert loops[True].episode_spec.sample(torch.Generator().manual_seed(0), (2,), dtype=loops[True].dtype,
                                           device=CPU).dtype == torch.float64
