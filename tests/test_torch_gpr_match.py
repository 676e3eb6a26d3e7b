"""The PyTorch port's GPR moment match against the JAX package, float64: the
unfused rule, the pair-grid route (K2 with R = 4 rows, its plain version
here) and the GPR whole match (K3g, its plain version here), each for one
GPR and for 3 stacked members against the JAX package's vmap. The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.moment_matching.gp import GPRTransform as JaxGPRTransform
from gpflowpilco_tpu.moment_matching.gp import gpr_match_cache as jax_gpr_match_cache
from gpflowpilco_tpu.moments import GaussianMoments as JaxMoments
from gpflowpilco_tpu.ops.kexp_pallas import build_fused_gpr_grid as jax_build_fused_gpr_grid
from gpflowpilco_tpu.ops.kexp_pallas import ekuffu_contract_gpr as jax_ekuffu_contract_gpr
from gpflowpilco_tpu.ops.mm_match_pallas import build_fused_gpr_match_grid as jax_build_match_grid
from gpflowpilco_tpu.ops.mm_match_pallas import fused_gpr_match as jax_fused_gpr_match
from gpflowpilco_torch.convert import gpr_from_numpy
from gpflowpilco_torch.moment_matching.gp import GPRTransform, gpr_match_cache
from gpflowpilco_torch.moments import GaussianMoments
from gpflowpilco_torch.ops.gpr_match_cuda import (build_fused_gpr_match_grid, fused_gpr_match,
                                                 gpr_match_reference_bwd)
from gpflowpilco_torch.ops.kexp_cuda import build_fused_gpr_grid, ekuffu_contract_gpr

from ._torch_export import CPU, gpr_to_numpy, jax_gpr, jax_gpr_members, t

torch.set_num_threads(1)
D, P = 4, 4


def _moments(seed, k=None):
    """mx (1, D), sxx (1, D, D), or (k, D), (k, D, D) for k members."""
    rng = np.random.default_rng(seed)
    n = 1 if k is None else k
    a = rng.normal(size=(n, D, D))
    mx = 0.3 * rng.normal(size=(n, D))
    sxx = 0.04 * a @ a.transpose(0, 2, 1) + 0.15 * np.eye(D)
    return mx, sxx


def _scaled(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


def _weights(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


@pytest.mark.parametrize("deterministic", [False, True])
def test_torch_match_gpr_matches_jax(deterministic):
    """Unfused match_gpr: f1, sff and cross to 1e-10 of each output's scale,
    and the gradient of a weighted sum of them in (mx, sxx) to 1e-9."""
    jm = jax_gpr(20, d=D, p=P)
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64)
    mx, sxx = _moments(21)
    w = _weights(22, [(1, P), (1, P, P), (1, D, P)])

    def jfn(m, s):
        out = JaxGPRTransform(model=jm, deterministic=deterministic).with_cache().moment_match(
            JaxMoments(mean=m, cov=s))
        outs = (out.y.mean, out.y.cov, out.cross_covariance(preinv=True))
        return sum(jnp.sum(wi * o) for wi, o in zip(w, outs)), outs

    (_, want), jgrad = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(mx), jnp.asarray(sxx))
    tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    out = GPRTransform(tm.requires_grad_(False), deterministic=deterministic).with_cache().moment_match(
        GaussianMoments(tmx, tsxx))
    outs = (out.y.mean, out.y.cov, out.cross_covariance(preinv=True))
    for got, ref in zip(outs, want):
        assert _scaled(got.detach(), ref) <= 1e-10
    sum(torch.sum(t(wi) * o) for wi, o in zip(w, outs)).backward()
    assert _scaled(tmx.grad, jgrad[0]) <= 1e-9
    assert _scaled(tsxx.grad, jgrad[1]) <= 1e-9


@pytest.mark.parametrize("stacked", [False, True])
def test_torch_gpr_pair_grid_route_matches_jax(stacked):
    """The pair-grid route (K2 with R = 4 rows of alpha^T): the port's plain
    version against the JAX package's ekuffu_contract_gpr with its Pallas
    kernel in interpret mode, 1e-10 of the scale; 3 stacked members (on the
    kernel's pair axis here) against the JAX package's vmap."""
    if stacked:
        jm = jax_gpr_members(23, d=D, p=P)
        mx, sxx = _moments(24, k=3)
    else:
        jm = jax_gpr(23, d=D, p=P)
        mx, sxx = _moments(24)

    def jone(m, a, s):
        c = jax_gpr_match_cache(m)
        grid = jax_build_fused_gpr_grid(m.kernel.variance, m.kernel.lengthscales, m.x, c.alpha, c.kyy_inv)
        return jax_ekuffu_contract_gpr(grid, a, s)

    with pltpu.force_tpu_interpret_mode():
        if stacked:
            want = jax.vmap(lambda m, a, s: jone(m, a[None], s[None]))(jm, jnp.asarray(mx), jnp.asarray(sxx))
            want = tuple(w[:, 0] for w in want)
        else:
            want = jone(jm, jnp.asarray(mx), jnp.asarray(sxx))
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64)
    with torch.no_grad():
        c = gpr_match_cache(tm, fused=True)
        assert c.fused_grid.alphat.shape == ((3 if stacked else 1), P, 30)
        got = ekuffu_contract_gpr(c.fused_grid, t(mx), t(sxx))
        ref_grid = build_fused_gpr_grid(tm.kernel.variance, tm.kernel.lengthscales, tm.x, c.alpha, c.kyy_inv)
        assert torch.equal(ref_grid.qm, c.fused_grid.qm)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _scaled(g, w) <= 1e-10


@pytest.mark.parametrize("stacked", [False, True])
def test_torch_gpr_whole_match_matches_jax(stacked):
    """The GPR whole match (K3g): the port's plain version against the JAX
    package's fused_gpr_match (Pallas, interpret mode), values and the
    frozen (mx, sxx) cotangents to 1e-9 of the scale; 3 stacked members,
    each matched against its own moments, against the JAX package's vmap."""
    if stacked:
        jm = jax_gpr_members(25, d=D, p=P)
        mx, sxx = _moments(26, k=3)
    else:
        jm = jax_gpr(25, d=D, p=P)
        mx, sxx = _moments(26)
    w = _weights(27, [(mx.shape[0], P), (mx.shape[0], P, P), (mx.shape[0], D, P)])

    def jone(m, a, s, wts):
        grid = jax_build_match_grid(m, uncertainty=True)
        outs = jax_fused_gpr_match(grid, a, s)
        return sum(jnp.sum(wi * o) for wi, o in zip(wts, outs)), outs

    with pltpu.force_tpu_interpret_mode():
        if stacked:
            def jsum(a, s):
                vals, outs = jax.vmap(lambda m, a1, s1, w0, w1, w2: jone(m, a1[None], s1[None], (w0, w1, w2)))(
                    jm, a, s, *(jnp.asarray(x)[:, None] for x in w))
                return jnp.sum(vals), tuple(o[:, 0] for o in outs)
        else:
            def jsum(a, s):
                return jone(jm, a, s, [jnp.asarray(x) for x in w])
        (_, want), jgrad = jax.value_and_grad(jsum, argnums=(0, 1), has_aux=True)(
            jnp.asarray(mx), jnp.asarray(sxx))

    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64).requires_grad_(False)
    c = gpr_match_cache(tm)
    grid = build_fused_gpr_match_grid(tm, c.alpha, c.kyy_inv, uncertainty=True)
    assert grid.meta.num_members == (3 if stacked else 1)
    tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    outs = fused_gpr_match(grid, tmx, tsxx)
    for g, ref in zip(outs, want):
        assert g.shape == ref.shape and _scaled(g.detach(), ref) <= 1e-9
    sum(torch.sum(t(wi) * o) for wi, o in zip(w, outs)).backward()
    assert _scaled(tmx.grad, jgrad[0]) <= 1e-9
    assert _scaled(tsxx.grad, jgrad[1]) <= 1e-9


@pytest.mark.parametrize("route", ["fused", "fused_match"])
def test_torch_gpr_kernel_routes_match_unfused(route):
    """Through GPRTransform, both kernel routes (their plain versions here)
    agree with the unfused rule on a stacked GPR with a batch of
    (2, 3 members) moments, values to 1e-10 of the scale."""
    jm = jax_gpr_members(28, d=D, p=P)
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64).requires_grad_(False)
    mx, sxx = _moments(29, k=6)
    x = GaussianMoments(t(mx).reshape(2, 3, D), t(sxx).reshape(2, 3, D, D))
    with torch.no_grad():
        ref = GPRTransform(tm).with_cache().moment_match(x)
        got = GPRTransform(tm, **{route: True}).with_cache().moment_match(x)
    for a, b in ((got.y.mean, ref.y.mean), (got.y.cov, ref.y.cov), (got.cross, ref.cross)):
        assert a.shape == b.shape and _scaled(a, b) <= 1e-10


# ---------------------------------------------------------------- tile split
def _gpr_tile_split(meta, g, mx, sxx, df1_in, dsff, dcross, tile):
    """The stages of csrc/gpr_match.cu's frozen backward, in float64 torch:
    each member's N x N grid cut into tile x tile cells; per tile, each
    row's partials (sum_j E sl, sum_j E s2, sum_j E s2 up_j) with sl_ij =
    vl_i.alpha_j + decov Kyy^-1_ij and s2_ij = vs_i.alpha_j + 2 decov
    Kyy^-1_ij; the partials added over the column tiles in tile order; then
    the finish's per-point adjoints (eKfu, and dup -> tmp_u after the
    sweep) and the combine's Cholesky adjoints. Returns (dmx, dsxx)."""
    from gpflowpilco_torch.ops import mm_match_cuda as mc
    from gpflowpilco_torch.ops.gpr_match_cuda import _solve, gpr_match_reference

    n = meta.num_n
    f1 = gpr_match_reference(meta, g, mx, sxx)[0]
    ch = torch.linalg.cholesky(sxx[:, :, None] + torch.diag_embed(g.kdiag))  # (B, K, 2, D, D)
    ch0, ch1 = ch[:, :, 0], ch[:, :, 1]
    diag0, diag1 = (torch.diagonal(c, dim1=-2, dim2=-1) for c in (ch0, ch1))
    # eKfu, a point per column
    y = _solve(ch0, g.xt - mx[..., None])  # (B, K, D, N)
    e = g.varr[:, None] * torch.exp((g.hll - torch.sum(torch.log(diag0), -1))[..., None]
                                    - 0.5 * torch.sum(y * y, -2))
    iv = _solve(ch0, y, trans=1)
    df1 = df1_in - ((dsff + dsff.mT) @ f1[..., None])[..., 0]  # (B, K, R)
    adc = dcross @ g.alpha.mT  # (B, K, D, N)
    ede = e * ((g.alpha @ df1[..., None])[..., 0] + torch.sum(iv * adc, -2))
    t_iv = _solve(ch0, e[..., None, :] * adc)
    dz = _solve(ch0, -y * ede[..., None, :] + t_iv, trans=1)
    dl0 = -torch.tril(iv @ t_iv.mT) - torch.tril(dz @ y.mT)
    dl0 = dl0 + torch.diag_embed(-torch.sum(ede, -1)[..., None] / diag0)
    # the pair's tiles
    ilu = _solve(ch1, g.ut)
    ilm = _solve(ch1, mx[..., None])
    up = ilu - 0.5 * ilm  # (B, K, D, N)
    hu = 0.5 * (g.g11 + torch.sum(up * up, -2))  # (B, K, N)
    cexp = g.cp - torch.sum(torch.log(diag1), -1)  # (B, K)
    vl = g.alpha @ dsff  # (B, K, N, R): dsff^T alpha_i
    vs = vl + g.alpha @ dsff.mT
    decov = -torch.diagonal(dsff, dim1=-2, dim2=-1).sum(-1) if meta.uncertainty else torch.zeros_like(cexp)
    spans = [(i, min(i + tile, n)) for i in range(0, n, tile)]
    parts = []  # per column tile: (B, K, D + 2, N)
    for j0, j1 in spans:
        rp = torch.zeros(mx.shape[:2] + (meta.num_dim + 2, n), dtype=mx.dtype)
        for i0, i1 in spans:
            mp = (up[..., i0:i1].mT @ up[..., j0:j1] - g.g1t[:, :, i0:i1].mT @ g.g1t[:, :, j0:j1]
                  + hu[..., i0:i1, None] + hu[..., None, j0:j1])
            ep = torch.exp(cexp[..., None, None] - mp)
            kq = decov[..., None, None] * g.kyy_inv[:, i0:i1, j0:j1]
            sl = vl[..., i0:i1, :] @ g.alpha[:, j0:j1].mT + kq
            s2 = vs[..., i0:i1, :] @ g.alpha[:, j0:j1].mT + 2.0 * kq
            rp[..., 0, i0:i1] = torch.sum(ep * sl, -1)
            rp[..., 1, i0:i1] = torch.sum(ep * s2, -1)
            rp[..., 2:, i0:i1] = ((ep * s2) @ up[..., j0:j1].mT).mT
        parts.append(rp)
    total = parts[0]
    for rp in parts[1:]:
        total = total + rp
    dsum, ssum, acc = total[..., 0, :], total[..., 1, :], total[..., 2:, :]
    dup = -acc + 2.0 * up * (-0.5 * ssum)[..., None, :]
    dilm = torch.sum(-0.5 * dup, -1)  # (B, K, D)
    tmp_u = _solve(ch1, dup, trans=1)
    tm = _solve(ch1, dilm[..., None], trans=1)
    dl1 = -torch.tril(tmp_u @ ilu.mT) - torch.tril(tm @ ilm.mT)
    dl1 = dl1 + torch.diag_embed(-torch.sum(dsum, -1)[..., None] / diag1)
    low = mc.chol_rev(ch0, dl0) + mc.chol_rev(ch1, dl1)
    return -torch.sum(dz, -1) + tm[..., 0], 0.5 * (low + low.mT)


@pytest.mark.parametrize("b, k, n, d, r, tile", [
    (1, 8, 240, 6, 4, 64),  # the HMC ensemble's shape, a ragged last tile
    (1, 3, 37, 4, 3, 64),   # below one tile
    (1, 2, 130, 10, 2, 64),  # D above the 8-register capacity, a tile plus 2
    (2, 3, 100, 6, 4, 64),  # a batch B = 2
    (1, 3, 240, 6, 4, 240),  # the whole grid as one tile
])
def test_torch_gpr_whole_match_tile_split_matches_reference(b, k, n, d, r, tile):
    """The tile decomposition of K3g's frozen backward (row partials of 64 x
    64 tiles of E, added over the column tiles in order, then the finish and
    the combine) against gpr_match_reference_bwd, in float64, to 1e-12 of
    each output's scale."""
    tm = gpr_from_numpy(gpr_to_numpy(jax_gpr_members(40 + n, k=k, n=n, d=d, p=r)), CPU,
                        torch.float64).requires_grad_(False)
    rng = np.random.default_rng(41 + n)
    a = rng.normal(size=(b, k, d, d))
    mx, sxx = t(0.3 * rng.normal(size=(b, k, d))), t(0.04 * a @ np.swapaxes(a, -1, -2) + 0.15 * np.eye(d))
    cots = (t(rng.normal(size=(b, k, r))), t(rng.normal(size=(b, k, r, r))), t(rng.normal(size=(b, k, d, r))))
    with torch.no_grad():
        c = gpr_match_cache(tm)
        grid = build_fused_gpr_match_grid(tm, c.alpha, c.kyy_inv, uncertainty=True)
        got = _gpr_tile_split(grid.meta, grid, mx, sxx, *cots, tile)
    want = gpr_match_reference_bwd(grid.meta, grid, mx, sxx, *cots)
    for what, x, w in zip(("dmx", "dsxx"), got, want):
        err = float((x - w).abs().max()) / float(w.abs().max())
        assert err <= 1e-12, (what, err)


def _gpr_fwd_tile_split(meta, g, mx, sxx, tile, latent):
    """The stages of csrc/gpr_match.cu's forward, in float64 torch: the eKfu
    blocks of ``latent`` points each (their f1 and cross partials), each
    member's N x N grid cut into tile x tile cells (per tile, f2's share
    alpha_i^T E alpha_j and ecov's sum Kyy^-1 o E), then the combine: the
    eKfu slots and the tile slots (ti-major) added in order, and sff.
    Returns (f1, sff, cross)."""
    from gpflowpilco_torch.ops.gpr_match_cuda import _solve

    n = meta.num_n
    ch = torch.linalg.cholesky(sxx[:, :, None] + torch.diag_embed(g.kdiag))  # (B, K, 2, D, D)
    ch0, ch1 = ch[:, :, 0], ch[:, :, 1]
    hls0, hls1 = (torch.sum(torch.log(torch.diagonal(c, dim1=-2, dim2=-1)), -1) for c in (ch0, ch1))
    # eKfu, a point per thread of a block
    y = _solve(ch0, g.xt - mx[..., None])  # (B, K, D, N)
    e = g.varr[:, None] * torch.exp((g.hll - hls0)[..., None] - 0.5 * torch.sum(y * y, -2))
    iv = _solve(ch0, y, trans=1)
    ae = e[..., None] * g.alpha  # (B, K, N, R)
    lat = [(ae[..., a:a + latent, :].sum(-2), iv[..., a:a + latent] @ ae[..., a:a + latent, :])
           for a in range(0, n, latent)]
    # the pair's tiles
    up = _solve(ch1, g.ut) - 0.5 * _solve(ch1, mx[..., None])  # (B, K, D, N)
    hu = 0.5 * (g.g11 + torch.sum(up * up, -2))  # (B, K, N)
    cexp = g.cp - hls1  # (B, K)
    spans = [(i, min(i + tile, n)) for i in range(0, n, tile)]
    pair = []
    for i0, i1 in spans:
        for j0, j1 in spans:
            mp = (up[..., i0:i1].mT @ up[..., j0:j1] - g.g1t[:, :, i0:i1].mT @ g.g1t[:, :, j0:j1]
                  + hu[..., i0:i1, None] + hu[..., None, j0:j1])
            ep = torch.exp(cexp[..., None, None] - mp)
            f2 = g.alpha[:, i0:i1].mT @ ep @ g.alpha[:, j0:j1]  # (B, K, R, R)
            ecov = torch.sum(g.kyy_inv[:, i0:i1, j0:j1] * ep, dim=(-2, -1))
            pair.append((f2, ecov))
    f1, cross = lat[0]
    for a, c in lat[1:]:
        f1, cross = f1 + a, cross + c
    f2, ecov = pair[0]
    for a, c in pair[1:]:
        f2, ecov = f2 + a, ecov + c
    sff = f2 - f1[..., :, None] * f1[..., None, :]
    if meta.uncertainty:
        sff = sff + torch.eye(meta.num_out, dtype=mx.dtype) * (g.varr - ecov)[..., None, None]
    return f1, sff, cross


@pytest.mark.parametrize("b, k, n, d, r, tile", [
    (1, 8, 240, 6, 4, 64),  # the HMC ensemble's shape, a ragged last tile
    (1, 3, 37, 4, 3, 64),   # below one tile
    (1, 2, 130, 10, 2, 64),  # D above the 8-register capacity, a tile plus 2
    (2, 3, 100, 6, 4, 64),  # a batch B = 2
    (1, 3, 240, 6, 4, 240),  # the whole grid as one tile
])
def test_torch_gpr_whole_match_fwd_tile_split_matches_reference(b, k, n, d, r, tile):
    """The tile decomposition of K3g's forward (64 x 64 tiles of E, each
    tile's f2 and ecov partials, the eKfu blocks of 256 points, and the
    combine's order) against gpr_match_reference, in float64, to 1e-12 of
    each output's scale."""
    from gpflowpilco_torch.ops.gpr_match_cuda import _LATENT, TILE, gpr_match_reference

    assert TILE == 64
    tm = gpr_from_numpy(gpr_to_numpy(jax_gpr_members(40 + n, k=k, n=n, d=d, p=r)), CPU,
                        torch.float64).requires_grad_(False)
    rng = np.random.default_rng(41 + n)
    a = rng.normal(size=(b, k, d, d))
    mx, sxx = t(0.3 * rng.normal(size=(b, k, d))), t(0.04 * a @ np.swapaxes(a, -1, -2) + 0.15 * np.eye(d))
    with torch.no_grad():
        c = gpr_match_cache(tm)
        grid = build_fused_gpr_match_grid(tm, c.alpha, c.kyy_inv, uncertainty=True)
        got = _gpr_fwd_tile_split(grid.meta, grid, mx, sxx, tile, _LATENT)
        want = gpr_match_reference(grid.meta, grid, mx, sxx)
    for what, x, w in zip(("f1", "sff", "cross"), got, want):
        err = float((x - w).abs().max()) / float(w.abs().max())
        assert err <= 1e-12, (what, err)
