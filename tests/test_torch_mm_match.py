"""The PyTorch port's whole SVGP match (ops/mm_match_cuda.py, the counterpart
of the Pallas kernel in ops/mm_match_pallas.py) held against the JAX package
in float64: the whole-match transform against the Pallas kernel (in TPU
interpret mode, as tests/test_mm_match_pallas.py runs it) and against the
JAX plain match_svgp; the frozen and full gradients, down to the model's
parameters; the plain hand adjoint against autograd of the plain forward.
On the CPU the op runs its plain version."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.moment_matching.gp import SVGPTransform as JaxSVGPTransform
from gpflowpilco_tpu.moments import GaussianMoments as JaxMoments
from gpflowpilco_torch.convert import svgp_from_numpy
from gpflowpilco_torch.moment_matching.gp import SVGPTransform, svgp_match_cache
from gpflowpilco_torch.moments import GaussianMoments
from gpflowpilco_torch.ops import mm_match_cuda as mc

from ._torch_export import CPU, jax_svgp, svgp_to_numpy, t

torch.set_num_threads(1)


def _models(seed, num_out=None, num_latent=3, m=9, d=4):
    jm = jax_svgp(seed, num_latent=num_latent, m=m, d=d, num_out=num_out)
    return jm, svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)


def _state(seed, d=4, n=3):
    rng = np.random.default_rng(seed)
    mx = 0.5 * rng.normal(size=(n, d))
    a = rng.normal(size=(n, d, d))
    return mx, 0.05 * a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(d)


def _weights(seed, num_out, d):
    rng = np.random.default_rng(seed)
    return rng.normal(size=num_out), rng.normal(size=(num_out, num_out)), rng.normal(size=(d, num_out))


def _scalar(lib, match, w):
    outs = (match.y.mean, match.y.cov, match.cross_covariance(preinv=True))
    if lib is jnp:
        return sum(jnp.sum(jnp.asarray(wi) * o) for wi, o in zip(w, outs)), outs
    return sum(torch.sum(t(wi) * o) for wi, o in zip(w, outs)), outs


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("num_out", [None, 2])
def test_torch_whole_match_values_match_jax(deterministic, num_out):
    """f1, sff and the premultiplied cross of the whole-match transform at a
    batch of N=3 states against the Pallas kernel (interpret mode) and the
    JAX plain match_svgp, with and without a mixing matrix and model
    uncertainty; rtol 1e-8."""
    jm, tm = _models(31, num_out=num_out)
    mx, sxx = _state(32)
    x = JaxMoments(mean=jnp.asarray(mx), cov=jnp.asarray(sxx))
    with pltpu.force_tpu_interpret_mode():
        want = JaxSVGPTransform(model=jm, deterministic=deterministic, fused_match=True)
        want = want.with_cache().moment_match(x)
    plain = JaxSVGPTransform(model=jm, deterministic=deterministic).with_cache().moment_match(x)
    got = SVGPTransform(tm, deterministic=deterministic, fused_match=True).with_cache()
    got = got.moment_match(GaussianMoments(t(mx), t(sxx)))
    for ref in (want, plain):
        for g, w in ((got.y.mean, ref.y.mean), (got.y.cov, ref.y.cov),
                     (got.cross_covariance(preinv=True), ref.cross_covariance(preinv=True))):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("frozen", [False, True])
def test_torch_whole_match_gradients_match_jax(frozen):
    """Gradients of a weighted sum of the match's outputs against the Pallas
    kernel's custom VJP (interpret mode), rtol 1e-6: in the state moments
    for the frozen and the full backward, and in every model parameter for
    the full one. Frozen, only mean_const (added outside the kernel) gets a
    model gradient."""
    jm, tm = _models(41, num_out=2)
    mx, sxx = _state(42, n=2)
    w = _weights(43, 2, 4)

    def jax_fn(model, m, s):
        tr = JaxSVGPTransform(model=model, fused_match=True, frozen=frozen).with_cache()
        return _scalar(jnp, tr.moment_match(JaxMoments(mean=m, cov=s)), w)[0]

    with pltpu.force_tpu_interpret_mode():
        jg_model, jg_mx, jg_sxx = jax.grad(jax_fn, argnums=(0, 1, 2))(
            jm, jnp.asarray(mx), jnp.asarray(sxx)
        )
    tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    tr = SVGPTransform(tm, fused_match=True, frozen=frozen).with_cache()
    _scalar(torch, tr.moment_match(GaussianMoments(tmx, tsxx)), w)[0].backward()
    np.testing.assert_allclose(tmx.grad.numpy(), np.asarray(jg_mx), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(tsxx.grad.numpy(), np.asarray(jg_sxx), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(tm.mean_const.grad.numpy(), np.asarray(jg_model.mean_const),
                               rtol=1e-10)
    pairs = [
        (tm.kernel.raw_variance, jg_model.kernel.raw_variance),
        (tm.kernel.raw_lengthscales, jg_model.kernel.raw_lengthscales),
        (tm.z, jg_model.z), (tm.q_mu, jg_model.q_mu), (tm.q_sqrt, jg_model.q_sqrt), (tm.w, jg_model.w),
    ]
    for got, want in pairs:
        if frozen and got is not tm.w:  # w mixes outside the kernel
            assert got.grad is None
            assert float(jnp.max(jnp.abs(want))) == 0.0
        else:
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("uncertainty", [False, True])
def test_torch_whole_match_hand_adjoint_matches_autograd(uncertainty):
    """The plain hand adjoint (frozen and full) against torch autograd of the
    plain forward, at ragged M and a batch, in every grid tensor; rtol 1e-9."""
    _, tm = _models(51, num_latent=2, m=7, d=3)
    mx, sxx = _state(52, d=3, n=2)
    cache = svgp_match_cache(tm, fused_match=True, uncertainty=uncertainty)
    grid = cache.match_grid
    leaves = [x.detach().clone().requires_grad_(True) for x in grid.tensors()]
    g = mc.FusedMatchGrid(**dict(zip(mc.GRID_FIELDS, leaves)), meta=grid.meta)
    tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    outs = mc.match_reference(grid.meta, g, tmx, tsxx)
    rng = np.random.default_rng(53)
    cots = [t(rng.normal(size=o.shape)) for o in outs]
    torch.autograd.backward(outs, cots)
    for frozen in (True, False):
        dmx, dsxx, dg = mc.match_reference_bwd(
            grid.meta, g, tmx.detach(), tsxx.detach(), *cots, frozen=frozen
        )
        torch.testing.assert_close(dmx, tmx.grad, rtol=1e-9, atol=1e-12)
        # autograd's Cholesky gradient is symmetric, as the adjoint's is
        torch.testing.assert_close(dsxx, tsxx.grad, rtol=1e-9, atol=1e-12)
        if frozen:
            assert dg is None
            continue
        for name, got, leaf in zip(mc.GRID_FIELDS, dg.tensors(), leaves):
            want = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12, msg=name)


def test_torch_whole_match_wrapper_checks_operands():
    """A D beyond the kernels' registers, mixed dtypes, a wrong shape and a
    grid built without model uncertainty for a match that asks for it raise,
    on the CPU too."""
    _, tm = _models(61, num_latent=2, m=5, d=17)
    grid = svgp_match_cache(tm, fused_match=True).match_grid
    mx, sxx = _state(62, d=17, n=1)
    with pytest.raises(ValueError, match="D <= 16"):
        mc.fused_svgp_match(grid, t(mx), t(sxx))
    _, tm = _models(63, num_latent=2, m=5, d=4)
    grid = svgp_match_cache(tm, fused_match=True).match_grid
    mx, sxx = _state(64, n=1)
    with pytest.raises(TypeError):
        mc.fused_svgp_match(grid, t(mx, torch.float32), t(sxx, torch.float32))
    with pytest.raises(ValueError, match="sxx"):
        mc._fwd(grid.meta, grid, t(mx), t(sxx)[:, :3])
    bad = SVGPTransform(tm, fused_match=True).with_cache()
    bad = SVGPTransform(tm, deterministic=True, cache=bad.cache, fused_match=True)
    with pytest.raises(ValueError, match="model_uncertainty"):
        bad.moment_match(GaussianMoments(t(mx), t(sxx)))
    shifted = dataclasses.replace(grid, zt=grid.zt[..., :-1])
    with pytest.raises(ValueError, match="zt"):
        mc.fused_svgp_match(shifted, t(mx), t(sxx))


@pytest.mark.parametrize("kind", ["fwd", "bwd_frozen", "bwd"])
def test_torch_whole_match_shared_memory_check_per_entry(kind):
    """Only the full backward stages a group's whole (4D + 4) x M factors in
    shared memory; the forward's and the frozen backward's tile blocks need
    the same bytes at any M. At D=16, M=800 in float32 the full backward's
    operands are refused and the others' pass."""
    d, m = 16, 800
    meta = mc.MatchMeta(num_latent=1, num_pairs=1, num_dim=d, num_m=m, uncertainty=True,
                        pairs=((0, 0),))
    shapes = dict(kdiag=(2, d), zt=(1, d, m), alpha=(1, m), varr=(1,), hll=(1,), qmat=(1, m, m),
                  ut=(1, d, m), wt=(1, d, m), g1t=(1, d, m), g2t=(1, d, m), g11=(1, m),
                  g22=(1, m), cp=(1,), alpha_u=(1, m), alpha_w=(1, m))
    grid = mc.FusedMatchGrid(**{f: torch.zeros(shapes[f]) for f in mc.GRID_FIELDS}, meta=meta)
    mx, sxx = torch.zeros(1, d), torch.zeros(1, d, d)
    assert mc.shared_bytes(meta, torch.float32, kind) == (
        (4 * d + 4) * m * 4 if kind == "bwd" else mc.shared_bytes(meta._replace(num_m=1),
                                                                   torch.float32, kind))
    if kind == "bwd":
        with pytest.raises(ValueError, match="shared memory"):
            mc.operand_check("svgp_match_bwd", kind, meta, grid, mx, sxx)
    else:
        assert mc.operand_check("svgp_match", kind, meta, grid, mx, sxx) == 1


# ---------------------------------------------------------------- tile split
def _tile_split(meta, g, mx, sxx, df1_in, dsff, dcross, ti, tj):
    """The stages of csrc/mm_match.cu's forward and frozen backward, in f64
    torch: each pair's M x M grid cut into ti x tj tiles; per tile the
    forward's partials (alpha_u^T E alpha_w, sum Q o E) and the backward's
    row and column partials of e dE (sum_j, sum_j wp_j; sum_i, sum_i up_i);
    the partials added over the tiles in tile order; then sff, and the
    adjoint that follows the sweep (dup, dwp -> tmp_u, tmp_w, tmp_m, dch,
    chol_rev) with the latent groups as match_reference_bwd has them.
    Returns (f1, sff, cross, dmx, dsxx)."""
    p = mc._forward_parts(meta, g, mx, sxx)
    pi, pj, diag_pos, full = mc._pair_index(meta, mx.device)
    n, num_p, m = mx.shape[0], meta.num_pairs, meta.num_m
    ch_p, up, wp = p["ch_p"], p["up"], p["wp"]
    hls_p = torch.sum(torch.log(torch.diagonal(ch_p, dim1=-2, dim2=-1)), -1)
    cexp = g.cp - hls_p  # (N, P)
    hu = 0.5 * (g.g11 + torch.sum(up * up, -2))  # (N, P, M)
    hw = 0.5 * (g.g22 + torch.sum(wp * wp, -2))
    q = torch.zeros((num_p, m, m), dtype=mx.dtype)
    if meta.uncertainty:
        q[diag_pos] = g.qmat
    ddiag = torch.diagonal(dsff, dim1=-2, dim2=-1)
    df2 = dsff[:, pi, pj] + torch.where(pi != pj, dsff[:, pj, pi], torch.zeros_like(dsff[:, pi, pj]))
    decov = torch.zeros((n, num_p), dtype=mx.dtype)
    if meta.uncertainty:
        decov[:, diag_pos] = -ddiag
    rows = [(i, min(i + ti, m)) for i in range(0, m, ti)]
    cols = [(j, min(j + tj, m)) for j in range(0, m, tj)]
    f2 = torch.zeros((n, num_p), dtype=mx.dtype)
    ecq = torch.zeros((n, num_p), dtype=mx.dtype)
    rs = torch.zeros((n, num_p, 1 + meta.num_dim, m), dtype=mx.dtype)  # rows: sum e dE, ... wp
    cs = torch.zeros_like(rs)  # columns: sum e dE, ... up
    for i0, i1 in rows:  # tile order: row tile, then column tile
        for j0, j1 in cols:
            mp = (-(g.g1t[..., i0:i1].mT @ g.g2t[..., j0:j1])
                  + up[..., i0:i1].mT @ wp[..., j0:j1]
                  + hu[..., i0:i1, None] + hw[..., None, j0:j1])
            e = torch.exp(cexp[..., None, None] - mp)  # (N, P, ti, tj)
            f2 = f2 + torch.einsum("pi,npij,pj->np", g.alpha_u[:, i0:i1], e, g.alpha_w[:, j0:j1])
            ecq = ecq + torch.sum(q[:, i0:i1, j0:j1] * e, (-2, -1))
            de = (df2[..., None, None] * g.alpha_u[:, i0:i1, None] * g.alpha_w[:, None, j0:j1]
                  + decov[..., None, None] * q[:, i0:i1, j0:j1])
            ede = e * de
            rs[..., 0, i0:i1] += ede.sum(-1)
            rs[..., 1:, i0:i1] += (ede @ wp[..., j0:j1].mT).mT
            cs[..., 0, j0:j1] += ede.sum(-2)
            cs[..., 1:, j0:j1] += up[..., i0:i1] @ ede
    f1 = p["f1"]
    sff = f2[:, full] - f1[:, :, None] * f1[:, None, :]
    if meta.uncertainty:
        sff = sff + torch.diag_embed(g.varr - ecq[:, diag_pos])

    # the latent groups, as match_reference_bwd
    ch_l, y, e_l, iv, ae = p["ch_l"], p["y"], p["e"], p["iv"], p["ae"]
    df1 = df1_in - ((dsff + dsff.mT) @ f1[..., None])[..., 0]
    dcr = dcross.mT
    dae = df1[..., None] + torch.sum(dcr[..., None] * iv, -2)
    ede_l = e_l * (g.alpha * dae)
    t_iv = mc._solve(ch_l, dcr[..., None] * ae[:, :, None, :])
    dzc = mc._solve(ch_l, 2.0 * y * (-0.5 * ede_l)[:, :, None, :] + t_iv, trans=1)
    dch_l = -torch.tril(iv @ t_iv.mT) - torch.tril(dzc @ y.mT)
    dch_l = dch_l + torch.diag_embed(-torch.sum(ede_l, -1)[..., None]
                                     / torch.diagonal(ch_l, dim1=-2, dim2=-1))
    dmx = -torch.sum(dzc, dim=(1, 3))
    # the pair groups, from the summed partials
    dup = -rs[..., 1:, :] + 2.0 * up * (-0.5 * rs[..., :1, :])
    dwp = -cs[..., 1:, :] + 2.0 * wp * (-0.5 * cs[..., :1, :])
    tmp_m = mc._solve(ch_p, (-0.5 * (dup.sum(-1) + dwp.sum(-1)))[..., None], trans=1)
    dch_p = -torch.tril(mc._solve(ch_p, dup, trans=1) @ p["ilu"].mT
                        + mc._solve(ch_p, dwp, trans=1) @ p["ilw"].mT + tmp_m @ p["ilm"].mT)
    dch_p = dch_p + torch.diag_embed(-rs[..., 0, :].sum(-1)[..., None]
                                     / torch.diagonal(ch_p, dim1=-2, dim2=-1))
    dmx = dmx + torch.sum(tmp_m[..., 0], 1)
    low = torch.sum(mc.chol_rev(p["ch"], torch.cat([dch_l, dch_p], 1)), 1)
    return f1, sff, p["cross"], dmx, 0.5 * (low + low.mT)


@functools.lru_cache(maxsize=None)
def _split_case(num_latent, d, m, unc):
    _, tm = _models(70 + m, num_latent=num_latent, m=m, d=d)
    return svgp_match_cache(tm, fused_match=True, uncertainty=unc).match_grid


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("num_latent, d, m, unc", [(4, 6, 240, True), (2, 4, 37, True), (1, 5, 30, False)])
@pytest.mark.parametrize("tile", ["64x64", "32x64", "MxM"])
def test_torch_whole_match_tile_split_matches_reference(tile, num_latent, d, m, unc, n):
    """The tile decomposition of the forward and the frozen backward (the
    drift's shape with its ragged last tile, M=37 and the policy's M=30, in
    tiles of 64 x 64, 32 x 64 and the whole grid, at N=1 and 3) against
    match_reference and match_reference_bwd(frozen=True), in float64, to
    1e-12 of each output's scale."""
    with torch.no_grad():
        grid = _split_case(num_latent, d, m, unc)
        ti, tj = (m, m) if tile == "MxM" else map(int, tile.split("x"))
        mx, sxx = _state(80 + n, d=d, n=n)
        rng = np.random.default_rng(90 + n)
        cots = (t(rng.normal(size=(n, num_latent))), t(rng.normal(size=(n, num_latent, num_latent))),
                t(rng.normal(size=(n, d, num_latent))))
        got = _tile_split(grid.meta, grid, t(mx), t(sxx), *cots, ti, tj)
        want = (*mc.match_reference(grid.meta, grid, t(mx), t(sxx)),
                *mc.match_reference_bwd(grid.meta, grid, t(mx), t(sxx), *cots, frozen=True)[:2])
    for what, a, b in zip(("f1", "sff", "cross", "dmx", "dsxx"), got, want):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-12, (what, err)


@pytest.mark.parametrize("num_latent, d, m, unc", [(1, 5, 30, False), (2, 4, 37, True)])
def test_torch_whole_match_full_backward_batch_is_sum_of_entries(num_latent, d, m, unc):
    """The decomposition that the full backward's batch on the block grid
    rests on: match_reference_bwd(frozen=False) on a batch of N=8 (the HMC
    ensemble policy's shape, and a ragged M=37 with model uncertainty)
    gives each entry's (dmx, dsxx) as its own one-entry call does, and grid
    cotangents equal to the per-entry ones added in the order n = 0..7, in
    float64, to 1e-12 of each output's scale."""
    n = 8
    with torch.no_grad():
        grid = _split_case(num_latent, d, m, unc)
        mx, sxx = (t(a) for a in _state(95, d=d, n=n))
        rng = np.random.default_rng(96)
        cots = (t(rng.normal(size=(n, num_latent))), t(rng.normal(size=(n, num_latent, num_latent))),
                t(rng.normal(size=(n, d, num_latent))))
        dmx, dsxx, dgrid = mc.match_reference_bwd(grid.meta, grid, mx, sxx, *cots, frozen=False)
        ones = [mc.match_reference_bwd(grid.meta, grid, mx[i:i + 1], sxx[i:i + 1],
                                       *(c[i:i + 1] for c in cots), frozen=False) for i in range(n)]
    summed = [sum(parts[1:], parts[0]) for parts in zip(*(o[2].tensors() for o in ones))]
    pairs = [("dmx", dmx, torch.cat([o[0] for o in ones])), ("dsxx", dsxx, torch.cat([o[1] for o in ones]))]
    pairs += list(zip(mc.GRID_FIELDS, dgrid.tensors(), summed))
    for what, a, b in pairs:
        err = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-300)
        assert a.shape == b.shape and err <= 1e-12, (what, err)
