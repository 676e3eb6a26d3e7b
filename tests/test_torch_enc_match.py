"""The PyTorch port's fused encoder match (ops/enc_match_cuda.py, the
counterpart of the Pallas kernel in ops/enc_match_pallas.py) held against
the JAX package in float64: values and gradients against the Pallas kernel
(in TPU interpret mode) and against the unfused Encoder.moment_match of both
packages, and the plain hand adjoint against autograd of the plain forward.
On the CPU the op runs its plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.components import trigonometric_encoder as jax_encoder
from gpflowpilco_tpu.moments import GaussianMoments as JaxMoments
from gpflowpilco_tpu.ops import enc_match_pallas as jenc
from gpflowpilco_torch.components import Encoder, trigonometric_encoder
from gpflowpilco_torch.moment_matching.rules import Sin
from gpflowpilco_torch.moments import GaussianMoments
from gpflowpilco_torch.ops import enc_match_cuda as ec

from ._torch_export import t

torch.set_num_threads(1)


def _state(seed, d=4, batch=(3,)):
    rng = np.random.default_rng(seed)
    mx = rng.normal(size=batch + (d,))
    a = rng.normal(size=batch + (d, d))
    return mx, 0.3 * a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d)


def _weights(seed, d, de, batch):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=batch + (de,)), rng.normal(size=batch + (de, de)),
            rng.normal(size=batch + (d, de)))


@pytest.mark.parametrize("active", [(1,), (1, 3), (3, 0), (0, 1, 2, 3)])
def test_torch_fused_encoder_matches_jax(active):
    """y_mean, y_cov and Cov(x, y) of Encoder(fused=True) and their
    gradients in the state moments, against the Pallas kernel's custom VJP
    (interpret mode) and the unfused matches of both packages; values to
    rtol 1e-11, gradients to rtol 1e-10. Active dims in any order, with and
    without inactive dims, on a batch of three states."""
    d = 4
    mx, sxx = _state(sum(active) + 10 * len(active))
    meta = jenc.make_enc_meta(active, d)
    w = _weights(7, d, 2 * len(active) + len(meta.inactive), (3,))

    def jax_fn(m, s, fused):
        if fused:
            outs = jenc.fused_encoder_match(meta, m, s)
        else:
            mt = jax_encoder(active).moment_match(JaxMoments(mean=m, cov=s))
            outs = (mt.y.mean, mt.y.cov, mt.cross_covariance(preinv=False))
        return sum(jnp.sum(jnp.asarray(wi) * o) for wi, o in zip(w, outs)), outs

    refs = []
    for fused in (True, False):
        with pltpu.force_tpu_interpret_mode():
            (_, outs), grads = jax.value_and_grad(
                lambda m, s: jax_fn(m, s, fused), argnums=(0, 1), has_aux=True
            )(jnp.asarray(mx), jnp.asarray(sxx))
        refs.append((outs, grads))

    got = {}
    for fused in (True, False):
        tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
        enc = Encoder(trigonometric_encoder(active).transform, active, fused=fused)
        mt = enc.moment_match(GaussianMoments(tmx, tsxx))
        outs = (mt.y.mean, mt.y.cov, mt.cross_covariance(preinv=False))
        sum(torch.sum(t(wi) * o) for wi, o in zip(w, outs)).backward()
        got[fused] = ([o.detach() for o in outs], (tmx.grad, tsxx.grad))
    for outs_ref, grads_ref in refs:
        for g, r in zip(got[True][0], outs_ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11, atol=1e-13)
        for g, r in zip(got[True][1], grads_ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-12)
    for g, r in zip(got[True][0] + list(got[True][1]), got[False][0] + list(got[False][1])):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


def test_torch_fused_encoder_hand_adjoint_matches_autograd():
    """The plain hand adjoint against autograd of the plain forward (one
    state has a negative active variance, where max(S_ii, 0) passes no
    gradient); rtol 1e-10."""
    meta = ec.make_enc_meta((2, 0), 5)
    mx, sxx = _state(21, d=5, batch=(4,))
    sxx[1, 2, 2] = -0.05
    tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    outs = ec.enc_match_reference(meta, tmx, tsxx)
    rng = np.random.default_rng(22)
    cots = [t(rng.normal(size=o.shape)) for o in outs]
    torch.autograd.backward(outs, cots)
    dmx, dsxx = ec.enc_match_reference_bwd(meta, tmx.detach(), tsxx.detach(), *cots)
    torch.testing.assert_close(dmx, tmx.grad, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(dsxx, tsxx.grad, rtol=1e-10, atol=1e-12)


def test_torch_fused_encoder_checks_operands():
    """A transform other than SinCos, a D beyond 16, repeated active dims and
    mixed dtypes raise, on the CPU too."""
    mx, sxx = _state(31, batch=(1,))
    with pytest.raises(ValueError, match="SinCos"):
        Encoder(Sin(), (1,), fused=True).moment_match(GaussianMoments(t(mx), t(sxx)))
    with pytest.raises(ValueError, match="active dims"):
        ec.make_enc_meta((1, 1), 4)
    wide = ec.make_enc_meta((1,), 17)
    mx17, sxx17 = _state(32, d=17, batch=(1,))
    with pytest.raises(ValueError, match="D <= 16"):
        ec.fused_encoder_match(wide, t(mx17), t(sxx17))
    with pytest.raises(TypeError):
        ec.fused_encoder_match(ec.make_enc_meta((1,), 4), t(mx), t(sxx, torch.float32))
