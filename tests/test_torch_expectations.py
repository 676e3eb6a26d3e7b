"""The rest of the port's Gaussian expectations held against the JAX package
in float64: ``bvn`` and ``bvn_cdf``, the single- and multi-output kernel
expectation wrappers of ``ops/kexp.py`` (also against the port's own full
eKuffu blocks), ``MatVec`` through ``forward_moments``, and the Monte-Carlo
checks of the JAX package's bivariate normal and kernel expectations, run
against the port at sample counts that keep each test to a few seconds."""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu import components as jcomp
from gpflowpilco_tpu import moments as jmom
from gpflowpilco_tpu.dynamics import forward as jforward
from gpflowpilco_tpu.dynamics import solvers as jsolvers
from gpflowpilco_tpu.models.kernels import RBF as JaxRBF
from gpflowpilco_tpu.moment_matching import rules as jrules
from gpflowpilco_tpu.ops import bvn as jbvn
from gpflowpilco_tpu.ops import kexp as jkexp
from gpflowpilco_torch import components as tcomp
from gpflowpilco_torch import moments as tmom
from gpflowpilco_torch.dynamics import forward as tforward
from gpflowpilco_torch.dynamics import solvers as tsolvers
from gpflowpilco_torch.models.kernels import RBF
from gpflowpilco_torch.moment_matching import rules as trules
from gpflowpilco_torch.ops import bvn as tbvn
from gpflowpilco_torch.ops import kexp as tkexp

from ._torch_export import t
from .utils import TestConfig, draw_samples_mvn, generate_covariance

torch.set_num_threads(1)


def _cos_ratio(got, want):
    got, want = np.ravel(got), np.ravel(want)
    return got @ want / (np.linalg.norm(got) * np.linalg.norm(want)), np.linalg.norm(got) / np.linalg.norm(want)


def _hold(torch_fn, jax_fn, inputs, diff_args, rtol=1e-10):
    """torch_fn and jax_fn on the same numpy inputs: the value within rtol of
    its scale, and the gradient of a random functional of it in the inputs
    named by ``diff_args`` at cosine and norm ratio within rtol of 1."""
    targs = [t(a).requires_grad_(i in diff_args) for i, a in enumerate(inputs)]
    got = torch_fn(*targs)
    w = np.random.default_rng(7).normal(size=tuple(got.shape))
    def functional(*a):
        out = jax_fn(*a)
        return jnp.sum(w * out), out

    (_, want_val), want_grads = jax.jit(jax.value_and_grad(functional, argnums=diff_args, has_aux=True))(
        *map(jnp.asarray, inputs))
    want_val = np.asarray(want_val)
    assert tuple(got.shape) == want_val.shape
    assert np.max(np.abs(got.detach().numpy() - want_val)) <= rtol * np.max(np.abs(want_val))
    torch.sum(t(w) * got).backward()
    for i, g in zip(diff_args, want_grads):
        cos, ratio = _cos_ratio(targs[i].grad.numpy(), np.asarray(g))
        assert cos >= 1.0 - rtol and abs(ratio - 1.0) <= rtol, (i, cos, ratio)


def test_torch_bvn_and_bvn_cdf_match_jax():
    """The rectangle probability and the lower-left CDF, values and
    gradients in every bound and the correlation, across both regimes of
    Genz's algorithm (|r| below and above 0.925)."""
    rng = np.random.default_rng(3)
    n = 40
    lo = rng.normal(size=(2, n)) - 0.5
    hi = lo + rng.uniform(0.1, 2.0, size=(2, n))
    r = np.concatenate([rng.uniform(-0.9, 0.9, n // 2), rng.choice([-1, 1], n // 2) * rng.uniform(0.93, 0.99, n // 2)])
    _hold(tbvn.bvn, jbvn.bvn, (lo[0], hi[0], lo[1], hi[1], r), (0, 1, 2, 3, 4))
    _hold(tbvn.bvn_cdf, jbvn.bvn_cdf, (hi[0], lo[1], r), (0, 1, 2))


def test_torch_bvnu_monte_carlo():
    """tests/test_bvn.py's Monte-Carlo check on the port: bvnu at six (h, k,
    r) against 2e6 correlated normal pairs, within 3e-3; bvn and bvn_cdf
    against the same samples."""
    z = np.random.default_rng(3).normal(size=(2_000_000, 2))
    for h, k, r in [(-0.5, 0.3, 0.8), (0.2, 0.2, 0.95), (1.0, -1.0, -0.97), (0.0, 0.5, 0.5),
                    (-1.5, -0.5, -0.3), (0.3, 0.3, 0.9999)]:
        x, y = z[:, 0], r * z[:, 0] + math.sqrt(1 - r**2) * z[:, 1]
        f = lambda fn, *a: float(fn(*(torch.tensor(v, dtype=torch.float64) for v in a)))  # noqa: E731
        assert abs(f(tbvn.bvnu, h, k, r) - np.mean((x > h) & (y > k))) < 3e-3, (h, k, r)
        assert abs(f(tbvn.bvn_cdf, h, k, r) - np.mean((x <= h) & (y <= k))) < 3e-3, (h, k, r)
        box = np.mean((x > h) & (x < h + 1.0) & (y > k) & (y < k + 0.5))
        assert abs(f(tbvn.bvn, h, h + 1.0, k, k + 0.5, r) - box) < 3e-3, (h, k, r)


def _kernel_case(seed, num_latent=3, m=6, d=4, batch=(2,)):
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.5, 1.5, num_latent)
    ls = rng.uniform(0.7, 2.0, (num_latent, d))
    z = rng.normal(size=(num_latent, m, d))
    mx = 0.5 * rng.normal(size=batch + (d,))
    a = rng.normal(size=batch + (d, d))
    sxx = 0.1 * a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(d)
    return var, ls, z, mx, sxx


def _jax_kernel(var, ls):
    return JaxRBF.create(jnp.asarray(var), jnp.asarray(ls))


def _torch_kernel(var, ls):
    """The two fields the wrappers read, as the given tensors (an RBF's own
    would be new leaves, cut from the inputs' gradients)."""
    return types.SimpleNamespace(variance=var, lengthscales=ls)


# name -> (torch fn, jax fn) on (var, ls, z, mx, sxx)
_WRAPPERS = {
    "ekff": (lambda v, l, z, m, s: tkexp.ekff(v[0], m), lambda v, l, z, m, s: jkexp.ekff(v[0], m)),
    "ekxz": (lambda v, l, z, m, s: tkexp.ekxz(v[0], l[0], z[0], m, s),
             lambda v, l, z, m, s: jkexp.ekxz(v[0], l[0], z[0], m, s)),
    "ekzxxz": (lambda v, l, z, m, s: tkexp.ekzxxz(v[0], l[0], z[0], v[1], l[1], z[1], m, s),
               lambda v, l, z, m, s: jkexp.ekzxxz(v[0], l[0], z[0], v[1], l[1], z[1], m, s)),
    "ekff_mo": (lambda v, l, z, m, s: tkexp.ekff_mo(_torch_kernel(v, l), m),
                lambda v, l, z, m, s: jkexp.ekff_mo(_jax_kernel(v, l), m)),
    "ekfu_mo": (lambda v, l, z, m, s: tkexp.ekfu_mo(_torch_kernel(v, l), z, m, s),
                lambda v, l, z, m, s: jkexp.ekfu_mo(_jax_kernel(v, l), z, m, s)),
    "ekuffu_mo": (lambda v, l, z, m, s: tkexp.ekuffu_mo(_torch_kernel(v, l), z, m, s),
                  lambda v, l, z, m, s: jkexp.ekuffu_mo(_jax_kernel(v, l), z, m, s)),
    "ekuffu_mo_diag": (lambda v, l, z, m, s: tkexp.ekuffu_mo_diag(_torch_kernel(v, l), z, m, s),
                       lambda v, l, z, m, s: jkexp.ekuffu_mo_diag(_jax_kernel(v, l), z, m, s)),
    "ekuffu_mo_diag_from_cache": (
        lambda v, l, z, m, s: tkexp.ekuffu_mo_diag_from_cache(
            tkexp.ekuffu_diag_cache(_torch_kernel(v, l), z), m, s),
        lambda v, l, z, m, s: jkexp.ekuffu_mo_diag_from_cache(
            jkexp.ekuffu_diag_cache(_jax_kernel(v, l), z), m, s)),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_torch_kexp_wrapper_matches_jax(name):
    """Each wrapper's value at 1e-10 of its scale on a batch of two input
    moments; its gradient in the moments, the lengthscales' raw values
    and the inducing points at cosine and norm ratio within 1e-10 of 1
    (ekff and ekff_mo depend on the variances alone)."""
    tfn, jfn = _WRAPPERS[name]
    diff = (0,) if name.startswith("ekff") else (1, 2, 3, 4)
    _hold(tfn, jfn, _kernel_case(11), diff)


def test_torch_kexp_wrappers_match_full_blocks():
    """The multi-output wrappers against the port's own full eKuffu from
    the pair cache (ekuffu_mo_from_cache) and against the single-output
    wrappers latent by latent, to 1e-14 of the scale."""
    var, ls, z, mx, sxx = (t(a) for a in _kernel_case(12, num_latent=4, m=5, d=3, batch=(3,)))
    kern = RBF.create(var, ls).requires_grad_(False)
    full = tkexp.ekuffu_mo_from_cache(tkexp.ekuffu_pair_cache(kern, z), 4, mx, sxx)  # (3, L, M, L, M)
    kv, kl = kern.variance, kern.lengthscales
    close = lambda a, b: float((a - b).abs().max()) <= 1e-14 * float(b.abs().max())  # noqa: E731
    assert close(tkexp.ekuffu_mo(kern, z, mx, sxx), full)
    diag = tkexp.ekuffu_mo_diag(kern, z, mx, sxx)
    ekfu = tkexp.ekfu_mo(kern, z, mx, sxx)
    assert diag.shape == (3, 4, 5, 5) and ekfu.shape == (3, 5, 4)
    for i in range(4):
        assert close(diag[:, i], full[:, i, :, i, :])
        assert close(ekfu[..., i], tkexp.ekxz(kv[i], kl[i], z[i], mx, sxx))
        for j in range(4):
            assert close(full[:, i, :, j, :], tkexp.ekzxxz(kv[i], kl[i], z[i], kv[j], kl[j], z[j], mx, sxx))
    assert torch.equal(tkexp.ekff_mo(kern, mx), kv.expand(3, 4))


def _mc_inducing(config, mx, sxx, ndims, num_inducing=32, scale_f=0.89):
    """tests/test_kernel_expectation.py's kernel and inducing points."""
    log_ls = jax.random.uniform(config.next_key(), (ndims,), minval=math.log(0.1), maxval=math.log(10.0),
                                dtype=config.dtype)
    z1 = draw_samples_mvn(config.next_key(), mx, 0.1 * sxx, num_inducing // 2)
    z2 = jax.random.uniform(config.next_key(), (num_inducing - z1.shape[0], ndims), dtype=config.dtype)
    return scale_f**2, np.exp(np.asarray(log_ls)), np.concatenate([np.asarray(z1), np.asarray(z2)])


@pytest.mark.parametrize("ndims", [2, 3])
def test_torch_kernel_expectations_mc(ndims):
    """tests/test_kernel_expectation.py's Monte-Carlo check on the port's
    ekxz and ekzxxz: the same draws (from the JAX test's keys) at 2e5
    samples, with that test's tolerance rule rtol = 10 / sqrt(samples)."""
    config = TestConfig(seed=1234 + ndims, num_samples=200_000)
    mx = jax.random.normal(config.next_key(), (ndims,), dtype=config.dtype)
    sxx = generate_covariance(config.next_key(), ndims, scale=0.10)
    v1, l1, za = _mc_inducing(config, mx, sxx, ndims)
    v2, l2, zb = _mc_inducing(config, mx, sxx, ndims)
    x = np.asarray(draw_samples_mvn(config.next_key(), mx, sxx, config.num_samples))
    m, s = t(np.asarray(mx))[None], t(np.asarray(sxx))[None]
    e_kxa = tkexp.ekxz(v1, t(l1), t(za), m, s)[0].numpy()
    e_kxb = tkexp.ekxz(v2, t(l2), t(zb), m, s)[0].numpy()
    e_axxb = tkexp.ekzxxz(t(v1), t(l1), t(za), t(v2), t(l2), t(zb), m, s)[0].numpy()

    def gram(v, ls, z):  # (M, S)
        d2 = np.sum(((z[:, None, :] - x[None]) / ls) ** 2, -1)
        return v * np.exp(-0.5 * d2)

    k_ax, k_bx = gram(v1, l1, za), gram(v2, l2, zb)
    for got, want in ((e_kxa, k_ax.mean(-1)), (e_kxb, k_bx.mean(-1)), (e_axxb, k_ax @ k_bx.T / x.shape[0])):
        assert np.all(np.abs(got - want) <= config.rtol + config.atol * np.abs(want))


def _affine_case(encoder):
    """tests/test_dynamics.py's affine compositions: MatVec policy and drift,
    with the cartpole encoder (D=4) or without (D=3, U=2)."""
    config = TestConfig(seed=42 if encoder else 44, num_samples=200_000)
    if encoder:
        d, u, de = 4, 1, 5
        a_pol = 0.3 * jax.random.normal(config.next_key(), (u, de), dtype=config.dtype)
        a_drift = 0.2 * jax.random.normal(config.next_key(), (d, de + u), dtype=config.dtype)
        scale = 0.3
    else:
        d, u = 3, 2
        a_pol = 0.4 * jax.random.normal(config.next_key(), (u, d), dtype=config.dtype)
        a_drift = 0.25 * jax.random.normal(config.next_key(), (d, d + u), dtype=config.dtype)
        scale = 0.4
    mx = jax.random.normal(config.next_key(), (1, d), dtype=config.dtype)
    sxx = generate_covariance(config.next_key(), d, batch_shape=(1,), scale=scale)
    xs = draw_samples_mvn(config.next_key(), mx, sxx, config.num_samples)[:, 0, :]
    return config, np.asarray(a_pol), np.asarray(a_drift), np.asarray(mx), np.asarray(sxx), np.asarray(xs)


@pytest.mark.parametrize("encoder", [True, False])
def test_torch_matvec_forward_moments(encoder):
    """MatVec as policy and drift through forward_moments (with the cartpole
    encoder and one 0.1 Euler step, or without an encoder), as
    tests/test_dynamics.py uses it: the port's moments equal JAX's to
    1e-12, and, the composition being exact for affine maps, the
    Monte-Carlo moments of the same samples within that test's rtol."""
    config, a_pol, a_drift, mx, sxx, xs = _affine_case(encoder)
    tenc = tcomp.trigonometric_encoder(active_dims=(1,)) if encoder else None
    jenc = jcomp.trigonometric_encoder(active_dims=(1,)) if encoder else None
    tpol, tdrift = trules.MatVec(t(a_pol)), trules.MatVec(t(a_drift))
    jpol, jdrift = jrules.MatVec(matrix=jnp.asarray(a_pol)), jrules.MatVec(matrix=jnp.asarray(a_drift))
    tx = tmom.GaussianMoments(t(mx), t(sxx))
    jx = jmom.GaussianMoments(mean=jnp.asarray(mx), cov=jnp.asarray(sxx))
    if encoder:
        dt = 0.1
        final, _, _ = tsolvers.moment_matching_euler_rollout(
            lambda k, xm: tforward.forward_moments(xm, tdrift, policy=tpol, encoder=tenc), tx, dt=dt,
            num_steps=1)
        jfinal, _, _, _ = jsolvers.moment_matching_euler_rollout(
            lambda k, xm: jforward.forward_moments(xm, jdrift, policy=jpol, encoder=jenc), jx, dt=dt,
            num_steps=1)
        got = (final.mean[0], final.cov[0])
        want = (jfinal.mean[0], jfinal.cov[0])
        samples = xs + dt * tforward.forward_concrete(t(xs), tdrift, policy=tpol, encoder=tenc).numpy()
    else:
        match = tforward.forward_moments(tx, tdrift, policy=tpol, encoder=None)
        jmatch = jforward.forward_moments(jx, jdrift, policy=jpol, encoder=None)
        got = (match.y.mean[0], match.y.cov[0], match.cross_covariance(preinv=False)[0])
        want = (jmatch.y.mean[0], jmatch.y.cov[0], jmatch.cross_covariance(preinv=False)[0])
        samples = tforward.forward_concrete(t(xs), tdrift, policy=tpol, encoder=None).numpy()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)
    mc_mean = samples.mean(0)
    ds = samples - mc_mean
    for g, w in ((got[0], mc_mean), (got[1], ds.T @ ds / len(samples))):
        assert np.all(np.abs(g.numpy() - w) <= config.rtol + config.atol * np.abs(w))
    if not encoder:
        mc_cross = (xs - mx[0]).T @ ds / len(xs)
        assert np.all(np.abs(got[2].numpy() - mc_cross) <= config.rtol + config.atol * np.abs(mc_cross))
