"""The PyTorch port's moment-matching rules held against the JAX package in
float64: the SVGP match (fused pair grid and unfused eKuffu), the elementary
rules, the encoder, the Gaussian cost on moments, the bivariate normal, the
PSD projection and the dtype island. Values and gradients of a fixed random
functional of the outputs in the input moments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu import components as jcomp
from gpflowpilco_tpu import moments as jmom
from gpflowpilco_tpu.moment_matching import rules as jrules
from gpflowpilco_tpu.moment_matching.gp import SVGPTransform as JaxSVGPTransform
from gpflowpilco_tpu.moment_matching.gp import match_svgp as jax_match
from gpflowpilco_tpu.ops import bvn as jbvn
from gpflowpilco_torch import components as tcomp
from gpflowpilco_torch import moments as tmom
from gpflowpilco_torch.convert import svgp_from_numpy
from gpflowpilco_torch.moment_matching import gp as gp_mod
from gpflowpilco_torch.moment_matching import rules as trules
from gpflowpilco_torch.moment_matching.gp import SVGPTransform, match_svgp
from gpflowpilco_torch.ops import bvn as tbvn

from ._torch_export import CPU, jax_svgp, svgp_to_numpy, t

torch.set_num_threads(1)


def _moments(seed, d, batch=(2,), scale=0.05):
    rng = np.random.default_rng(seed)
    mx = 0.5 * rng.normal(size=batch + (d,))
    a = rng.normal(size=batch + (d, d))
    return mx, scale * a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(d)


def _weights(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


def _compare_match(jax_match_fn, torch_match_fn, mx, sxx, rtol, grad_rtol, interpret=False):
    """Run both matches on (mx, sxx); compare y.mean, y.cov, the preinv cross
    and the gradient of sum(w1 mean) + sum(w2 cov) + sum(w3 cross) in (mx, sxx)."""
    torch_x = tmom.GaussianMoments(t(mx).requires_grad_(True), t(sxx).requires_grad_(True))
    tm = torch_match_fn(torch_x)
    outs = (tm.y.mean, tm.y.cov, tm.cross_covariance(preinv=True))
    ws = _weights(0, [tuple(o.shape) for o in outs])

    def jax_fn(m, s):
        jm = jax_match_fn(jmom.GaussianMoments(mean=m, cov=s))
        jo = (jm.y.mean, jm.y.cov, jm.cross_covariance(preinv=True))
        return sum(jnp.sum(w * o) for w, o in zip(ws, jo)), jo

    fn = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True))
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            (_, want), want_grads = fn(jnp.asarray(mx), jnp.asarray(sxx))
    else:
        (_, want), want_grads = fn(jnp.asarray(mx), jnp.asarray(sxx))
    for name, got, w in zip(("mean", "cov", "cross"), outs, want):
        assert tuple(got.shape) == w.shape, name
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=rtol, atol=rtol * 1e-3,
                                   err_msg=name)
    sum(torch.sum(t(w) * o) for w, o in zip(ws, outs)).backward()
    for name, got, w in zip(("d mean", "d cov"), (torch_x.mean.grad, torch_x.cov.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=grad_rtol, atol=grad_rtol * 1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("whiten", [True, False])
def test_torch_match_svgp_matches_jax(fused, deterministic, whiten):
    """match_svgp with and without the pair-grid op against the JAX package
    (its Pallas path in interpret mode): mean, cov and the preinv cross at
    rtol 1e-9, the gradient in the input moments at rtol 1e-8."""
    jm = jax_svgp(31, num_latent=3, m=9, d=5, whiten=whiten)
    tm = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)
    mx, sxx = _moments(32, 5)
    jt = JaxSVGPTransform(model=jm, deterministic=deterministic, fused=fused)
    tt = SVGPTransform(tm, deterministic=deterministic, fused=fused)
    with pltpu.force_tpu_interpret_mode():
        jt = jt.with_cache()
    tt = tt.with_cache()
    assert (tt.cache.fused_grid is not None) == fused
    _compare_match(jt.moment_match, tt.moment_match, mx, sxx, 1e-9, 1e-8, interpret=fused)


@pytest.mark.parametrize("fused", [False, True])
def test_torch_match_svgp_lck_matches_jax(fused, monkeypatch):
    """A linear-coregionalization SVGP (mixing matrix w, 4 outputs from 2
    latents), with model uncertainty and diagonalized output covariance;
    and the diagonal-only match of an SVGP without a mixing matrix."""
    jm = jax_svgp(41, num_latent=2, m=7, d=4, num_out=4)
    tm = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)
    mx, sxx = _moments(42, 4)
    with pltpu.force_tpu_interpret_mode():
        jt = JaxSVGPTransform(model=jm, fused=fused).with_cache()
    tt = SVGPTransform(tm, fused=fused).with_cache()
    _compare_match(
        lambda x: jax_match(jm, x, full_output_cov=False, cache=jt.cache),
        lambda x: match_svgp(tm, x, full_output_cov=False, cache=tt.cache),
        mx, sxx, 1e-9, 1e-8, interpret=fused,
    )
    # without a mixing matrix, full_output_cov=False is the diagonal-only
    # path: it equals JAX's, with and without model uncertainty, and never
    # reaches the pair-grid op, even with a fused cache
    js = jax_svgp(43, num_latent=3, m=7, d=4)
    single = svgp_from_numpy(svgp_to_numpy(js), CPU, torch.float64).requires_grad_(False)
    with pltpu.force_tpu_interpret_mode():
        jcache = JaxSVGPTransform(model=js, fused=fused).with_cache().cache
    tcache = SVGPTransform(single, fused=fused).with_cache().cache

    def no_pair_grid(*args):
        raise AssertionError("the diagonal-only match reached the pair-grid op")

    monkeypatch.setattr(gp_mod, "ekuffu_contract_fused", no_pair_grid)
    for unc in (True, False):
        _compare_diag_match(
            lambda x: jax_match(js, x, model_uncertainty=unc, full_output_cov=False, cache=jcache),
            lambda x: match_svgp(single, x, model_uncertainty=unc, full_output_cov=False, cache=tcache),
            mx, sxx,
        )


def _compare_diag_match(jax_match_fn, torch_match_fn, mx, sxx):
    """The diagonal-only match on (mx, sxx): mean, cov and the preinv cross
    within 1e-10 of each output's scale, the output cov diagonal, and the
    gradient of a random functional of the three in (mx, sxx) at cosine and
    norm ratio within 1e-10 of 1."""
    torch_x = tmom.GaussianMoments(t(mx).requires_grad_(True), t(sxx).requires_grad_(True))
    tm = torch_match_fn(torch_x)
    outs = (tm.y.mean, tm.y.cov, tm.cross_covariance(preinv=True))
    ws = _weights(1, [tuple(o.shape) for o in outs])

    def jax_fn(m, s):
        jm = jax_match_fn(jmom.GaussianMoments(mean=m, cov=s))
        jo = (jm.y.mean, jm.y.cov, jm.cross_covariance(preinv=True))
        return sum(jnp.sum(w * o) for w, o in zip(ws, jo)), jo

    (_, want), want_grads = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True))(
        jnp.asarray(mx), jnp.asarray(sxx))
    for name, got, w in zip(("mean", "cov", "cross"), outs, want):
        w = np.asarray(w)
        assert tuple(got.shape) == w.shape, name
        assert np.max(np.abs(got.detach().numpy() - w)) <= 1e-10 * np.max(np.abs(w)), name
    cov = outs[1].detach().numpy()
    assert np.array_equal(cov, np.eye(cov.shape[-1]) * cov)
    sum(torch.sum(t(w) * o) for w, o in zip(ws, outs)).backward()
    got = np.concatenate([torch_x.mean.grad.numpy().ravel(), torch_x.cov.grad.numpy().ravel()])
    want = np.concatenate([np.asarray(g).ravel() for g in want_grads])
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    ratio = np.linalg.norm(got) / np.linalg.norm(want)
    assert cos >= 1.0 - 1e-10 and abs(ratio - 1.0) <= 1e-10, (cos, ratio)


@pytest.mark.parametrize("rule", ["sincos", "probit", "squashed_probit"])
def test_torch_rules_match_jax(rule):
    """SinCos, Probit (through the Genz BVN) and SquashedProbit: values at
    rtol 1e-10 and gradients at rtol 1e-9, on moments wide enough that
    the probit correlations reach the strong-correlation branch."""
    mx, sxx = _moments(51, 3, scale=1.0 if rule != "sincos" else 0.2)
    mx = 2.0 * mx
    pairs = {
        "sincos": (jrules.SinCos(), trules.SinCos()),
        "probit": (jrules.Probit(), trules.Probit()),
        "squashed_probit": (jrules.SquashedProbit(scale=jnp.asarray(19.99999)),
                            trules.SquashedProbit(scale=19.99999)),
    }
    jr, tr = pairs[rule]
    _compare_match(jr.moment_match, lambda x: trules.moment_matching(x, tr), mx, sxx, 1e-10, 1e-9)


def test_torch_encoder_moment_match_matches_jax():
    """The cartpole encoder (sincos of the angle, the other dims appended)
    on 4-D state moments: the stitched joint and the raw cross."""
    mx, sxx = _moments(61, 4, scale=0.3)
    jenc = jcomp.trigonometric_encoder(active_dims=(1,))
    tenc = tcomp.trigonometric_encoder(active_dims=(1,))
    _compare_match(jenc.moment_match, tenc.moment_match, mx, sxx, 1e-10, 1e-9)
    m = tenc.moment_match(tmom.GaussianMoments(t(mx), t(sxx)))
    assert not m.preinv and m.y.mean.shape == (2, 5) and m.cross.shape == (2, 4, 5)


@pytest.mark.parametrize("sqrt_path", [True, False])
def test_torch_gaussian_objective_on_moments_matches_jax(sqrt_path):
    """The expected cartpole cost under Gaussian feature moments, through
    the precision's square root (``create``) and through the LU solve."""
    rng = np.random.default_rng(71)
    h = 0.6
    precis = 16.0 * np.array(
        [[h * h, 0, -h, 0, 0], [0, h * h, 0, 0, 0], [-h, 0, 1, 0, 0], [0] * 5, [0] * 5]
    )
    target = np.array([0.0, 1.0, 0.0, 0.0, 0.0])
    mx, sxx = _moments(72, 5, batch=(3, 2), scale=0.1)
    if sqrt_path:
        jobj = jcomp.GaussianObjective.create(target=jnp.asarray(target), precis=jnp.asarray(precis))
        tobj = tcomp.GaussianObjective.create(target=t(target), precis=t(precis))
        np.testing.assert_allclose(tobj.precis_sqrt.numpy(), np.asarray(jobj.precis_sqrt),
                                   rtol=1e-10, atol=1e-12)
    else:
        jobj = jcomp.GaussianObjective(target=jnp.asarray(target), precis=jnp.asarray(precis))
        tobj = tcomp.GaussianObjective(target=t(target), precis=t(precis))
    w = rng.normal(size=(3, 2))

    def jax_fn(m, s):
        c = jobj(jmom.GaussianMoments(mean=m, cov=s))
        return jnp.sum(w * c), c

    (_, want), want_grads = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True))(
        jnp.asarray(mx), jnp.asarray(sxx)
    )
    tm, ts = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    got = tobj(tmom.GaussianMoments(tm, ts))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-10)
    torch.sum(t(w) * got).backward()
    for g, wg in zip((tm.grad, ts.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-9, atol=1e-13)


def test_torch_bvnu_values_and_gradients_match_jax():
    """Genz's bivariate normal upper probability across both correlation
    regimes, infinite bounds, and |r| at and near 1, against the JAX
    package's value and custom-JVP gradients."""
    rng = np.random.default_rng(81)
    h = np.concatenate([rng.normal(size=40) * 2.0, [-np.inf, 0.3, np.inf, 1.0, -0.5]])
    k = np.concatenate([rng.normal(size=40) * 2.0, [0.2, -np.inf, 0.1, 1.0, -0.5]])
    r = np.concatenate([rng.uniform(-1.0, 1.0, size=20), rng.choice([-1, 1], 20) *
                        rng.uniform(0.9, 1.0, size=20), [0.5, -0.3, 0.9, 1.0, -1.0]])
    w = rng.normal(size=h.shape)
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda a, b, c: jnp.sum(w * jbvn.bvnu(a, b, c)), argnums=(0, 1, 2)
    ))(jnp.asarray(h), jnp.asarray(k), jnp.asarray(r))
    np.testing.assert_allclose(
        tbvn.bvnu(t(h), t(k), t(r)).numpy(), np.asarray(jbvn.bvnu(h, k, r)), rtol=1e-12, atol=1e-15
    )
    finite = np.isfinite(h) & np.isfinite(k)
    th, tk, tr = (t(a[finite]).requires_grad_(True) for a in (h, k, r))
    torch.sum(t(w[finite]) * tbvn.bvnu(th, tk, tr)).backward()
    for g, wg in zip((th.grad, tk.grad, tr.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg)[finite], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(
        tbvn.owens_t(t(h[:40]), t(np.abs(r[:40]))).numpy(),
        np.asarray(jbvn.owens_t(jnp.asarray(h[:40]), jnp.asarray(np.abs(r[:40])))),
        rtol=1e-12, atol=1e-15,
    )


def test_torch_psd_project_matches_jax():
    """An indefinite and a positive definite covariance: the boost lifts only
    the first, and it carries no gradient."""
    rng = np.random.default_rng(91)
    a = rng.normal(size=(2, 4, 4))
    cov = np.stack([a[0] + a[0].T, a[1] @ a[1].T + 0.1 * np.eye(4)])
    mean = rng.normal(size=(2, 4))
    w = rng.normal(size=(2, 4, 4))

    def jax_fn(s):
        p = jmom.psd_project(jmom.GaussianMoments(mean=jnp.asarray(mean), cov=s))
        return jnp.sum(w * p.cov), p.cov

    (_, want), want_grad = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(cov))
    ts = t(cov).requires_grad_(True)
    got = tmom.psd_project(tmom.GaussianMoments(t(mean), ts))
    np.testing.assert_allclose(got.cov.detach().numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert np.linalg.eigvalsh(got.cov.detach().numpy()[0]).min() >= -1e-12
    np.testing.assert_array_equal(got.cov.detach().numpy()[1], 0.5 * (cov[1] + cov[1].T))
    torch.sum(t(w) * got.cov).backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_grad), rtol=1e-12)


def test_torch_dtype_island_matches_jax():
    """The float32 policy chain inside float64 moments: the match comes back
    in float64 with the outer x kept, and gradients cross both casts, to the
    float64 input moments and to the float32 policy parameters. Both sides
    compute the island in float32, so they agree to float32 rounding."""
    jpol = jax_svgp(101, num_latent=1, m=6, d=5, dtype=jnp.float32)
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float32)
    mx, sxx = _moments(102, 5, batch=(1,), scale=0.1)
    scale = 2.0 * 10.0 - 1e-5
    jisland = jmom.DtypeIsland(
        inner=jmom.Chain(jrules.SquashedProbit(scale=jnp.asarray(scale, jnp.float32)),
                         JaxSVGPTransform(model=jpol, deterministic=True).with_cache()),
        dtype=jnp.float32, outer=jnp.float64,
    )

    def tisland():  # the cache's graph is consumed by each backward
        return tmom.DtypeIsland(
            inner=tmom.Chain(trules.SquashedProbit(scale=scale),
                             SVGPTransform(tpol, deterministic=True).with_cache()),
            dtype=torch.float32, outer=torch.float64,
        )

    _compare_match(jisland.moment_match, tisland().moment_match, mx, sxx, 2e-5, 2e-4)
    tpol.zero_grad()
    x = tmom.GaussianMoments(t(mx).requires_grad_(True), t(sxx).requires_grad_(True))
    m = tisland().moment_match(x)
    assert m.x is x and m.y.mean.dtype == m.y.cov.dtype == m.cross.dtype == torch.float64
    joint = m.joint()
    torch.sum(joint.cov).backward()
    assert tpol.q_mu.grad is not None and tpol.q_mu.grad.dtype == torch.float32
    assert torch.isfinite(tpol.q_mu.grad).all() and float(tpol.q_mu.grad.abs().max()) > 0
    assert x.mean.grad.dtype == torch.float64 and torch.isfinite(x.cov.grad).all()
    feats = t(mx[:, :5])
    np.testing.assert_allclose(
        tisland()(feats).detach().numpy(), np.asarray(jisland(jnp.asarray(mx[:, :5]))), rtol=2e-5
    )
