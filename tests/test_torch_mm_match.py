"""The PyTorch port's whole SVGP match (ops/mm_match_cuda.py, the counterpart
of the Pallas kernel in ops/mm_match_pallas.py) held against the JAX package
in float64: the whole-match transform against the Pallas kernel (in TPU
interpret mode, as tests/test_mm_match_pallas.py runs it) and against the
JAX plain match_svgp; the frozen and full gradients, down to the model's
parameters; the plain hand adjoint against autograd of the plain forward.
On the CPU the op runs its plain version."""
import dataclasses

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
