"""The PyTorch port's eKuffu pair-grid contraction (ops/kexp_cuda.py, the
counterpart of the Pallas kernel in ops/kexp_pallas.py) and the kernel
expectations around it (ops/kexp.py), held against the JAX package in
float64. On the CPU the op runs its plain version; the Pallas kernel runs in
TPU interpret mode, as tests/test_kexp_pallas.py runs it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.moment_matching.gp import svgp_match_cache as jax_match_cache
from gpflowpilco_tpu.ops import kexp as jkexp
from gpflowpilco_tpu.ops import kexp_pallas as jkp
from gpflowpilco_torch.convert import svgp_from_numpy
from gpflowpilco_torch.moment_matching.gp import svgp_match_cache
from gpflowpilco_torch.ops import kexp
from gpflowpilco_torch.ops import kexp_cuda as kc

from ._torch_export import CPU, jax_svgp, svgp_to_numpy, t

torch.set_num_threads(1)


def _operands(rng, n, p, d2, m, r=1):
    """su, sw with su^T sw >= 0 (so E = exp(-su^T sw) <= 1, as in the pair
    grid), alu, qm and the two cotangents, as numpy."""
    su = np.abs(rng.normal(size=(n, p, d2, m))) / d2
    sw = np.abs(rng.normal(size=(n, p, d2, m))) / d2
    return dict(
        su=su, sw=sw, alu=rng.normal(size=(p, r, m)), qm=rng.normal(size=(p, m, m)),
        devc=rng.normal(size=(n, p, r, m)), dqcol=rng.normal(size=(n, p, m)),
    )


def _jax_contract(su, sw, alu, qm):
    """The Pallas kernel applied per batch entry: evc (N, P, R, M), qcol (N, P, M)."""
    outs = [jkp.fused_pair_contract(su[i], sw[i], alu, qm) for i in range(su.shape[0])]
    return jnp.stack([o[0] for o in outs]), jnp.stack([o[1][:, 0, :] for o in outs])


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("m", [17, 30])
def test_torch_pair_contract_matches_pallas_kernel(n, p, m):
    """Forward and VJP of FusedPairContract against the Pallas kernel's
    custom VJP, at ragged M and a batch; rtol 1e-10 in float64. The gradients
    of the shared alu and qm are summed over the batch on both sides."""
    o = _operands(np.random.default_rng(100 * n + 10 * p + m), n, p, 10, m)
    with pltpu.force_tpu_interpret_mode():
        (w_evc, w_qcol), vjp = jax.vjp(
            _jax_contract, *(jnp.asarray(o[k]) for k in ("su", "sw", "alu", "qm"))
        )
        want_grads = vjp((jnp.asarray(o["devc"]), jnp.asarray(o["dqcol"])))

    ins = [t(o[k]).requires_grad_(True) for k in ("su", "sw", "alu", "qm")]
    evc, qcol = kc.FusedPairContract.apply(*ins)
    np.testing.assert_allclose(evc.detach().numpy(), np.asarray(w_evc), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(qcol.detach().numpy(), np.asarray(w_qcol), rtol=1e-10, atol=1e-12)
    torch.autograd.backward((evc, qcol), (t(o["devc"]), t(o["dqcol"])))
    for name, x, want in zip(("su", "sw", "alu", "qm"), ins, want_grads):
        np.testing.assert_allclose(
            x.grad.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12, err_msg=name
        )


def test_torch_pair_contract_gradcheck_and_frozen_backward():
    """Finite differences of the Function in float64, and the frozen backward
    (alu and qm need no gradient) gives the same dsu, dsw as the full one."""
    o = _operands(np.random.default_rng(7), 2, 2, 4, 5, r=2)
    ins = [t(o[k]).requires_grad_(True) for k in ("su", "sw", "alu", "qm")]
    assert torch.autograd.gradcheck(kc.FusedPairContract.apply, ins, eps=1e-6, atol=1e-8)

    args = [t(o[k]) for k in ("su", "sw", "alu", "qm", "devc", "dqcol")]
    full = kc.pair_contract_reference_bwd(*args, True)
    frozen = kc.pair_contract_reference_bwd(*args, False)
    assert frozen[2] is None and frozen[3] is None
    torch.testing.assert_close(frozen[0], full[0], rtol=0, atol=0)
    torch.testing.assert_close(frozen[1], full[1], rtol=0, atol=0)

    su, sw = (a.clone().requires_grad_(True) for a in args[:2])
    evc, qcol = kc.FusedPairContract.apply(su, sw, args[2], args[3])
    torch.autograd.backward((evc, qcol), (args[4], args[5]))
    torch.testing.assert_close(su.grad, full[0], rtol=0, atol=0)
    torch.testing.assert_close(sw.grad, full[1], rtol=0, atol=0)


def test_torch_pair_contract_wrapper_checks_operands():
    """Wrong shapes, mixed or unsupported dtypes and a D2 beyond the
    kernels' registers raise before anything runs, on the CPU too."""
    o = _operands(np.random.default_rng(3), 2, 3, 6, 9)
    su, sw, alu, qm, devc, dqcol = (t(o[k]) for k in ("su", "sw", "alu", "qm", "devc", "dqcol"))
    with pytest.raises(ValueError, match="qm"):
        kc.FusedPairContract.apply(su, sw, alu, qm[:, :-1])
    with pytest.raises(ValueError, match="sw"):
        kc.FusedPairContract.apply(su, sw[:1], alu, qm)
    with pytest.raises(ValueError, match="dqcol"):
        kc._bwd(su, sw, alu, qm, devc, dqcol[..., :-1], True)
    with pytest.raises(TypeError):
        kc.FusedPairContract.apply(su, sw, alu.float(), qm)
    with pytest.raises(TypeError):
        kc.FusedPairContract.apply(*(a.half() for a in (su, sw, alu, qm)))
    wide = torch.zeros((1, 1, 33, 9), dtype=torch.float64)
    with pytest.raises(ValueError, match="D2"):
        kc.FusedPairContract.apply(wide, wide, alu[:1], qm[:1])


def _models(seed, num_latent=3, m=8, d=5):
    jm = jax_svgp(seed, num_latent=num_latent, m=m, d=d)
    return jm, svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)


def _state_moments(seed, d, batch=(2,)):
    rng = np.random.default_rng(seed)
    mx = 0.5 * rng.normal(size=batch + (d,))
    a = rng.normal(size=batch + (d, d))
    sxx = 0.05 * a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(d)
    return mx, sxx


def test_torch_kexp_helpers_match_jax():
    """ekxz_isolve and the unfused eKuffu (pair cache + per-step assembly)
    against the JAX package, on a batch of two states; rtol 1e-10."""
    jm, tm = _models(11)
    mx, sxx = _state_moments(12, 5)
    lam_j = jkexp.latent_lam(jm.kernel, 5)
    lam_t = kexp.latent_lam(tm.kernel, 5)
    np.testing.assert_allclose(lam_t.detach().numpy(), np.asarray(lam_j), rtol=1e-12)

    want = jax.jit(jkexp.ekxz_isolve)(
        jm.kernel.variance, lam_j, jm.z, jnp.asarray(mx), jnp.asarray(sxx)
    )
    got = kexp.ekxz_isolve(tm.kernel.variance, lam_t, tm.z, t(mx), t(sxx))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-10, atol=1e-14)

    want = jax.jit(
        lambda kern, z, m, s: jkexp.ekuffu_mo_from_cache(jkexp.ekuffu_pair_cache(kern, z), 3, m, s)
    )(jm.kernel, jm.z, jnp.asarray(mx), jnp.asarray(sxx))
    got = kexp.ekuffu_mo_from_cache(kexp.ekuffu_pair_cache(tm.kernel, tm.z), 3, t(mx), t(sxx))
    assert got.shape == want.shape == (2, 3, 8, 3, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-10, atol=1e-14)


def test_torch_ekuffu_contract_fused_matches_jax():
    """The fused pair grid end to end (grid build, per-step Cholesky and
    solves, the contraction, the scatter) against the JAX package's Pallas
    path in interpret mode: values at rtol 1e-10, and gradients in the state
    moments and the model's q_mu and z at rtol 1e-9."""
    jm, tm = _models(21, num_latent=3, m=11, d=4)
    mx, sxx = _state_moments(22, 4)
    wf = np.random.default_rng(23).normal(size=(3, 3))
    we = np.random.default_rng(24).normal(size=3)

    def jax_fn(model, m, s):
        cache = jax_match_cache(model, fused=True)
        f2, ecov = jkp.ekuffu_contract_fused(cache.fused_grid, m, s)
        return jnp.sum(f2 * wf) + jnp.sum(ecov * we), (f2, ecov)

    with pltpu.force_tpu_interpret_mode():
        (_, (w_f2, w_ecov)), w_grads = jax.jit(
            jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True)
        )(jm, jnp.asarray(mx), jnp.asarray(sxx))

    tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    cache = svgp_match_cache(tm, fused=True)
    f2, ecov = kc.ekuffu_contract_fused(cache.fused_grid, tmx, tsxx)
    np.testing.assert_allclose(f2.detach().numpy(), np.asarray(w_f2), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(ecov.detach().numpy(), np.asarray(w_ecov), rtol=1e-10, atol=1e-14)
    (torch.sum(f2 * t(wf)) + torch.sum(ecov * t(we))).backward()
    jg_model, jg_mx, jg_sxx = w_grads
    for got, want in (
        (tmx.grad, jg_mx), (tsxx.grad, jg_sxx), (tm.q_mu.grad, jg_model.q_mu), (tm.z.grad, jg_model.z),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)


def _frozen_tile_split(su, sw, alu, qm, devc, dqcol, tile):
    """The stages of csrc/kexp_pair.cu's frozen backward, in float64 torch:
    each (n, p) grid cut into tile x tile cells; per tile, E evaluated once,
    g = -E o (alu^T devc + qm o dqcol), the row partial g sw_tile^T into
    dsu's slab of the column tile and the column partial su_tile g into
    dsw's slab of the row tile; then each slab list added in tile order.
    Returns (dsu, dsw)."""
    m = su.shape[-1]
    spans = [(i, min(i + tile, m)) for i in range(0, m, tile)]
    dsu_p = torch.zeros((len(spans),) + su.shape, dtype=su.dtype)
    dsw_p = torch.zeros((len(spans),) + sw.shape, dtype=sw.dtype)
    for ti, (i0, i1) in enumerate(spans):
        for tj, (j0, j1) in enumerate(spans):
            e = torch.exp(-(su[..., i0:i1].mT @ sw[..., j0:j1]))
            g = -e * (alu[:, :, i0:i1].mT @ devc[..., j0:j1] + qm[:, i0:i1, j0:j1] * dqcol[..., None, j0:j1])
            dsu_p[tj][..., i0:i1] = sw[..., j0:j1] @ g.mT
            dsw_p[ti][..., j0:j1] = su[..., i0:i1] @ g
    dsu, dsw = dsu_p[0], dsw_p[0]
    for a, b in zip(dsu_p[1:], dsw_p[1:]):
        dsu, dsw = dsu + a, dsw + b
    return dsu, dsw


@pytest.mark.parametrize("n, p, d2, m, r", [
    (1, 10, 14, 240, 1),  # the MM drift's shape
    (3, 3, 14, 17, 1),    # below one tile, a batch N = 3
    (2, 2, 20, 45, 1),    # D2 above 16
    (1, 1, 12, 30, 1),    # the policy's shape
    (1, 8, 14, 240, 4),   # the GPR route: 8 members on P, R = 4 rows of alpha^T
])
def test_torch_pair_contract_frozen_tile_split_matches_reference(n, p, d2, m, r):
    """The tile decomposition of K2's frozen backward (E once per tile of
    the kernel's side, row and column partials from that one tile, added in
    tile order) against pair_contract_reference_bwd(..., False), in
    float64, to 1e-12 of each output's scale."""
    o = _operands(np.random.default_rng(1000 + m + r), n, p, d2, m, r=r)
    args = [t(o[k]) for k in ("su", "sw", "alu", "qm", "devc", "dqcol")]
    got = _frozen_tile_split(*args, kc.FROZEN_TILE)
    want = kc.pair_contract_reference_bwd(*args, False)
    for what, x, w in zip(("dsu", "dsw"), got, want[:2]):
        err = float((x - w).abs().max()) / float(w.abs().max())
        assert err <= 1e-12, (what, err)


def test_torch_pair_contract_frozen_partials_layout():
    """The frozen backward's scratch: two partial slabs per tile of M, (2,
    N, P, ceil(M / FROZEN_TILE), D2, M), and none when one tile covers M
    (the policy's M = 30 and a tile side of 32)."""
    assert kc.FROZEN_TILE == 32
    like = torch.zeros(1, dtype=torch.float64)
    assert kc.frozen_partials(1, 10, 14, 240, like).shape == (2, 1, 10, 8, 14, 240)
    assert kc.frozen_partials(3, 3, 14, 33, like).shape == (2, 3, 3, 2, 14, 33)
    assert kc.frozen_partials(1, 1, 12, 30, like).numel() == 0
