"""The PyTorch port's path-eval kernel op (gpflowpilco_torch/ops/path_eval_cuda.py)
held against the JAX package.

On the CPU the op runs its plain-torch version and backward formulas; the
JAX fused op runs its Pallas kernel in interpret mode. Tolerances: 2e-5 in
float32 (the JAX kernel's own parity bar against its unfused path), 1e-10 in
float64 (the same arithmetic in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.models.pathwise import PathState as JaxPathState
from gpflowpilco_tpu.models.pathwise import eval_paths_svgp as jax_eval
from gpflowpilco_torch.convert import paths_from_numpy, svgp_from_numpy
from gpflowpilco_torch.models.pathwise import PathState, eval_paths_svgp
from gpflowpilco_torch.ops import path_eval_cuda as pe

from ._torch_export import CPU, TORCH_DTYPE, jax_svgp, paths_to_numpy, svgp_to_numpy

torch.set_num_threads(1)


def _setup(dtype, s=48, num_latent=3, m=12, b=40, d=5, seed=3, num_out=None):
    jm = jax_svgp(seed, num_latent, m, d, dtype, num_out=num_out)
    # evaluation needs any paths, not posterior ones: numpy draws of the right scale
    rng = np.random.default_rng(seed + 1)
    jpaths = JaxPathState(
        omega=jnp.asarray(rng.normal(size=(num_latent, b, d)), dtype),
        phase=jnp.asarray(rng.uniform(0, 2 * np.pi, size=(num_latent, b)), dtype),
        w=jnp.asarray(rng.normal(size=(s, num_latent, b)), dtype),
        v=jnp.asarray(rng.normal(size=(s, num_latent, m)), dtype),
    )
    x = rng.normal(size=(s, d))
    tdtype = TORCH_DTYPE[dtype]
    model = svgp_from_numpy(svgp_to_numpy(jm), CPU, tdtype).requires_grad_(False)
    paths = paths_from_numpy(paths_to_numpy(jpaths), CPU, tdtype)
    return jm, jpaths, jnp.asarray(x, dtype), model, paths, torch.as_tensor(x, dtype=tdtype)


def test_torch_fused_matches_jax_fused_interpret_f32():
    from jax.experimental.pallas import tpu as pltpu

    from gpflowpilco_tpu.ops import path_eval_pallas as jpe

    jm, jpaths, jx, model, paths, x = _setup(jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpe.eval_paths_svgp_fused(jm, jpaths, jx))
    got = pe.eval_paths_svgp_fused(model, paths, x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("num_out", [None, 2])
def test_torch_fused_matches_unfused_f64(num_out):
    jm, jpaths, jx, model, paths, x = _setup(jnp.float64, num_out=num_out)
    want = np.asarray(jax_eval(jm, jpaths, jx))
    fused = pe.eval_paths_svgp_fused(model, paths, x).numpy()
    plain = eval_paths_svgp(model, paths, x).numpy()
    np.testing.assert_allclose(plain, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(fused, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("free_paths", [False, True])
def test_torch_fused_grads_match_jax_grad(free_paths):
    """dx with frozen paths; dx, dw and dv with free paths, against jax.grad
    of the JAX package's eval_paths_svgp (float64)."""
    jm, jpaths, jx, model, paths, x = _setup(jnp.float64)

    def jax_loss(x_, w_, v_):
        p = dataclasses.replace(jpaths, w=w_, v=v_)
        return jnp.sum(jnp.sin(jax_eval(jm, p, x_)))

    argnums = (0, 1, 2) if free_paths else (0,)
    want = jax.grad(jax_loss, argnums=argnums)(jx, jpaths.w, jpaths.v)

    x = x.clone().requires_grad_(True)
    w = paths.w.clone().requires_grad_(free_paths)
    v = paths.v.clone().requires_grad_(free_paths)
    f = pe.eval_paths_svgp_fused(model, PathState(paths.omega, paths.phase, w, v), x)
    torch.sum(torch.sin(f)).backward()
    got = (x.grad, w.grad, v.grad) if free_paths else (x.grad,)
    if not free_paths:
        assert w.grad is None and v.grad is None
    for g, wnt, name in zip(got, want, ("dx", "dw", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-9, atol=1e-12, err_msg=name)


def test_torch_frozen_paths_take_dx_only_branch(monkeypatch):
    used = []
    orig_dx, orig_full = pe._bwd_dx, pe._bwd_full
    monkeypatch.setattr(pe, "_bwd_dx", lambda *a: (used.append("dx"), orig_dx(*a))[1])
    monkeypatch.setattr(pe, "_bwd_full", lambda *a: (used.append("full"), orig_full(*a))[1])
    _, _, _, model, paths, x = _setup(jnp.float64, s=16, b=16, m=6)

    x1 = x.clone().requires_grad_(True)
    pe.eval_paths_svgp_fused(model, paths, x1).sum().backward()
    assert used == ["dx"]

    used.clear()
    w = paths.w.clone().requires_grad_(True)
    pe.eval_paths_svgp_fused(model, paths._replace(w=w), x).sum().backward()
    assert used == ["full"] and w.grad is not None


def test_torch_fused_refuses_grads_it_cannot_give():
    _, _, _, model, paths, x = _setup(jnp.float64, s=8, b=8, m=4)
    omega = paths.omega.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError):
        pe.eval_paths_svgp_fused(model, paths._replace(omega=omega), x)
    model.kernel.raw_lengthscales.requires_grad_(True)  # a drift hyperparameter
    with pytest.raises(NotImplementedError):
        pe.eval_paths_svgp_fused(model, paths, x)


def test_torch_path_eval_operand_shapes_are_checked():
    """The CUDA wrapper validates every operand's shape before it passes
    pointers to the kernel."""
    _, _, _, model, paths, x = _setup(jnp.float32, s=8, b=8, m=4)
    ops = (x, *pe.fused_operands(model, paths))
    g = torch.zeros((8, 3))
    assert pe.operand_shape(*ops, g) == (8, 3, 8, 4, 5)
    with pytest.raises(ValueError, match="phase"):
        pe.operand_shape(*ops[:4], ops[4][:, :1], *ops[5:])
    with pytest.raises(ValueError, match="g has"):
        pe.operand_shape(*ops, g[:, :2])
    with pytest.raises(ValueError, match="D <= 16"):
        wide = torch.zeros((8, 17))
        pe.operand_shape(wide, *ops[1:3], torch.zeros((3, 8, 17)), ops[4],
                         torch.zeros((3, 4, 17)), ops[6], torch.zeros((3, 17)))


def test_torch_path_eval_launch_counts_stay_zero_on_cpu():
    pe.reset_launches()
    for dtype in (jnp.float32, jnp.float64):
        _, _, _, model, paths, x = _setup(dtype, s=8, b=8, m=4)
        x = x.requires_grad_(True)
        pe.eval_paths_svgp_fused(model, paths, x).sum().backward()
    assert pe.launches == {"path_eval_fwd": 0, "path_eval_bwd_dx": 0, "path_eval_bwd_full": 0,
                           "path_eval_fwd_f64": 0, "path_eval_bwd_dx_f64": 0, "path_eval_bwd_full_f64": 0}


def _forward_warp_split(x, w, v, omega, phase, z_scaled, z2, inv_ls):
    """The order of csrc/path_eval.cu's forward, in torch: per (particle,
    latent) the bases' terms cos(x . omega + phase) w and the centers'
    exp(-|x~ - z~|^2 / 2) v, each row zero-padded to a multiple of 4 and
    concatenated, cut into groups of 4 columns; lane j adds the groups j, j
    + 32, ... in order (a group's 4 terms in order), and the 32 lane sums
    meet by the butterfly (xor 16, 8, 4, 2, 1), read at lane 0. Returns f
    (S, L)."""
    proj, _, k = pe._proj_and_k(x, omega, phase, z_scaled, z2, inv_ls)
    pad = lambda a: torch.nn.functional.pad(a, (0, -a.shape[-1] % 4))  # noqa: E731
    terms = torch.cat([pad(torch.cos(proj) * w), pad(k * v)], dim=-1)
    s, num_latent, cols = terms.shape
    groups = torch.nn.functional.pad(terms.reshape(s, num_latent, cols // 4, 4), (0, 0, 0, -(cols // 4) % 32))
    groups = groups.reshape(s, num_latent, -1, 32, 4)  # (..., item, lane, 4)
    acc = torch.zeros((s, num_latent, 32), dtype=terms.dtype)
    for item in range(groups.shape[2]):
        for q in range(4):
            acc = acc + groups[:, :, item, :, q]
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ off]
    return acc[..., 0]


@pytest.mark.parametrize("b, m, d", [(1024, 240, 6), (1000, 239, 6), (70, 19, 12), (9, 3, 16)])
def test_torch_path_eval_forward_warp_split_matches_reference(b, m, d):
    """K1a's lane-to-column partition and the order its sums meet (every
    column once, the pads adding zeros) against path_eval_reference in
    float64, to 1e-12 of the output's scale: at the pathwise path's B =
    1024, M = 240, at B and M that are not multiples of 4 and 32, and below
    one round of 32 groups."""
    rng = np.random.default_rng(b + m + d)
    s, num_latent = 8, 3
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float64)  # noqa: E731
    z = f(num_latent, m, d)
    ops = (f(s, d), 0.05 * f(s, num_latent, b), 0.1 * f(s, num_latent, m), f(num_latent, b, d),
           f(num_latent, b), z, (z * z).sum(-1), f(num_latent, d).abs() + 0.5)
    got = _forward_warp_split(*ops)
    want = pe.path_eval_reference(*ops)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_torch_path_eval_forward_plan():
    """fwd_plan: the panels' chunk width is a multiple of 128 and covers all
    columns in one chunk at the pathwise path's widths (1024 + 240 columns,
    D = 6: 1280 wide, 101,376 bytes with the ring); where the columns
    outgrow shared memory (D = 16, 2500 + 12 columns) it is the widest
    multiple of 128 that fits, and the forward stages two chunks."""
    assert pe.fwd_plan(1024, 240, 6) == (1280, pe.FWD_RING_BYTES + 7 * 4 * 1280)
    assert pe.fwd_plan(1000, 239, 6)[0] == 1280
    assert pe.fwd_plan(9, 3, 16)[0] == 128
    cw, nbytes = pe.fwd_plan(2500, 10, 16)
    assert cw == 2432 and -(-2512 // cw) == 2
    for b, m, d in ((1024, 240, 6), (1000, 239, 12), (2500, 10, 16), (100000, 240, 6)):
        cw, nbytes = pe.fwd_plan(b, m, d)
        assert cw % 128 == 0 and 0 < nbytes <= pe.FWD_SMEM_MAX
        assert nbytes + 4 * (d + 1) * 128 > pe.FWD_SMEM_MAX or cw >= b + m


def _backward_warp_split(x, w, v, omega, phase, z_scaled, z2, inv_ls, g):
    """The order of csrc/path_eval.cu's dx-only backward, in torch: per
    (particle, latent) the columns of the bases (c = -sin(x . omega + phase)
    w, with omega's row) and of the centers (kv = exp(-|x~ - z~|^2 / 2) v,
    with z~'s row scaled by il), each zero-padded to a multiple of 4 and
    concatenated, cut into groups of 4; lane j takes the groups j, j + 32,
    ... in order (a group's 4 columns in order) and adds acc += c row, and
    kvsum += kv for the centers. Both sums meet by the butterfly (xor 16,
    8, 4, 2, 1); lane 0 forms g (acc - kvsum x~ il), and the latents'
    partials are added l = 0, 1, ... in order. Returns dx (S, D)."""
    proj, xs, k = pe._proj_and_k(x, omega, phase, z_scaled, z2, inv_ls)
    pad = lambda a, dim=-1: torch.nn.functional.pad(  # noqa: E731
        a, (0, 0) * (-1 - dim) + (0, -a.shape[dim] % 4))
    coef = torch.cat([pad(-torch.sin(proj) * w), pad(k * v)], dim=-1)  # (S, L, cols)
    rows = torch.cat([pad(omega, -2), pad(z_scaled * inv_ls[:, None, :], -2)], dim=-2)  # (L, cols, D)
    bw = coef.shape[-1] - pad(v).shape[-1]
    s, num_latent, cols = coef.shape
    d = x.shape[1]
    items = -(-cols // 128)
    lanes = torch.arange(32)
    acc, kvsum = torch.zeros((s, num_latent, 32, d), dtype=x.dtype), torch.zeros((s, num_latent, 32), dtype=x.dtype)
    for item in range(items):
        for q in range(4):
            col = 4 * (lanes + 32 * item) + q
            live = col < cols
            col = torch.where(live, col, 0)
            c = torch.where(live, coef[..., col], 0.0)  # (S, L, 32)
            acc = acc + c[..., None] * rows[:, col, :]
            kvsum = torch.where(col < bw, kvsum, kvsum + c)
    for off in (16, 8, 4, 2, 1):
        acc, kvsum = acc + acc[:, :, lanes ^ off], kvsum + kvsum[..., lanes ^ off]
    part = g[..., None] * (acc[:, :, 0] - kvsum[..., 0, None] * xs * inv_ls)  # (S, L, D)
    dx = part[:, 0]
    for l in range(1, num_latent):
        dx = dx + part[:, l]
    return dx


@pytest.mark.parametrize("b, m, d", [(1024, 240, 6), (1000, 239, 6), (70, 19, 12), (9, 3, 16)])
def test_torch_path_eval_backward_warp_split_matches_reference(b, m, d):
    """K1b's lane-to-column partition (the forward's), the centers' rows
    scaled by il into the bases' sum, its butterfly, g applied once at the
    end and the latents added in order, against
    path_eval_reference_bwd in float64, to 1e-12 of dx's scale: at the
    pathwise path's B = 1024, M = 240, at B and M that are not multiples of
    4 and 32, and below one round of 32 groups."""
    rng = np.random.default_rng(b + m + d)
    s, num_latent = 8, 4
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float64)  # noqa: E731
    z = f(num_latent, m, d)
    ops = (f(s, d), 0.05 * f(s, num_latent, b), 0.1 * f(s, num_latent, m), f(num_latent, b, d),
           f(num_latent, b), z, (z * z).sum(-1), f(num_latent, d).abs() + 0.5)
    g = f(s, num_latent)
    got = _backward_warp_split(*ops, g)
    want = pe.path_eval_reference_bwd(*ops, g, want_wv=False)[0]
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
