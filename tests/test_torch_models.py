"""The PyTorch port's models, initializers and linear algebra held against
the JAX package in float64 on exported models (tolerance 1e-10 unless
stated: the same arithmetic, in another library)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.models import gp as jgp
from gpflowpilco_tpu.models import initializers as jinit
from gpflowpilco_tpu.models.kernels import square_distance as jax_square_distance
from gpflowpilco_tpu.models.pathwise import generate_paths_svgp as jax_generate
from gpflowpilco_tpu.models.priors import pilco_snr_penalty as jax_snr
from gpflowpilco_tpu.ops.linalg import safe_cholesky as jax_safe_cholesky
from gpflowpilco_tpu.utils import bijectors as jbij
from gpflowpilco_torch.convert import svgp_from_numpy
from gpflowpilco_torch.models import gp as tgp
from gpflowpilco_torch.models import initializers as tinit
from gpflowpilco_torch.models.builders import build_svgp, dynamics_mask, policy_mask
from gpflowpilco_torch.models.kernels import square_distance
from gpflowpilco_torch.models.pathwise import PathNoise, paths_from_noise
from gpflowpilco_torch.models.priors import pilco_snr_penalty
from gpflowpilco_torch.ops.linalg import safe_cholesky
from gpflowpilco_torch.utils import bijectors as tbij

from ._torch_export import CPU, jax_path_draws, jax_svgp, svgp_to_numpy, t

torch.set_num_threads(1)
TOL = dict(rtol=1e-10, atol=1e-12)


def _pair(seed=0, whiten=True, num_out=None):
    jm = jax_svgp(seed, num_latent=3, m=8, d=5, whiten=whiten, num_out=num_out)
    return jm, svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)


def _close(got, want, **kw):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **{**TOL, **kw},
    )


def test_torch_bijectors_match_jax():
    raw = np.linspace(-6.0, 6.0, 25)
    _close(tbij.positive(t(raw)), jbij.positive(jnp.asarray(raw)))
    _close(tbij.sigmoid_interval(t(raw), 0.01, 100.0), jbij.sigmoid_interval(jnp.asarray(raw), 0.01, 100.0))
    val = np.linspace(0.05, 50.0, 25)
    _close(tbij.positive_inv(t(val)), jbij.positive_inv(jnp.asarray(val)))
    _close(tbij.sigmoid_interval_inv(t(val), 0.01, 100.0),
           jbij.sigmoid_interval_inv(jnp.asarray(val), 0.01, 100.0))


def test_torch_kernel_gram_and_kuu_match_jax():
    jm, tm = _pair()
    x = np.random.default_rng(1).normal(size=(7, 5))
    _close(tm.kernel.gram(tm.z), jm.kernel.gram(jm.z))
    _close(tm.kernel.gram(t(x)[None], tm.z), jm.kernel.gram(jnp.asarray(x)[None], jm.z))
    _close(tgp.kuu(tm), jgp.kuu(jm))
    _close(tgp.chol_kuu(tm), jgp.chol_kuu(jm))
    _close(square_distance(t(x), tm.z), jax_square_distance(jnp.asarray(x), jm.z))


@pytest.mark.parametrize("whiten,num_out", [(True, None), (False, None), (True, 2)])
def test_torch_svgp_predict_elbo_kl_match_jax(whiten, num_out):
    jm, tm = _pair(seed=2, whiten=whiten, num_out=num_out)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9, 5))
    y = rng.normal(size=(9, num_out or 3))
    weights = np.r_[np.ones(6), np.zeros(3)]
    for full in (False, True):
        tm_mean, tm_var = tgp.svgp_predict_f(tm, t(x), full_output_cov=full)
        jm_mean, jm_var = jgp.svgp_predict_f(jm, jnp.asarray(x), full_output_cov=full)
        _close(tm_mean, jm_mean)
        _close(tm_var, jm_var)
    _close(tgp.kl_qu_pu(tm), jgp.kl_qu_pu(jm))
    _close(tgp.svgp_elbo(tm, t(x), t(y)), jgp.svgp_elbo(jm, jnp.asarray(x), jnp.asarray(y)))
    _close(
        tgp.svgp_elbo(tm, t(x), t(y), num_data=20, weights=t(weights)),
        jgp.svgp_elbo(jm, jnp.asarray(x), jnp.asarray(y), num_data=20, weights=jnp.asarray(weights)),
    )


@pytest.mark.parametrize("num_out", [None, 2])
def test_torch_snr_penalty_matches_jax(num_out):
    jm, tm = _pair(seed=4, num_out=num_out)
    _close(pilco_snr_penalty(tm, 1e5, 30.0), jax_snr(jm, 1e5, 30.0))
    # and its gradient in raw space, one to one
    pilco_snr_penalty(tm, 1e2, 4.0).backward()
    want = jax.grad(lambda m: jax_snr(m, 1e2, 4.0))(jm)
    _close(tm.kernel.raw_variance.grad, want.kernel.raw_variance)
    _close(tm.raw_noise.grad, want.raw_noise)


@pytest.mark.parametrize("case", ["clean", "escalates", "fails"])
def test_torch_safe_cholesky_matches_jax(case):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 6, 4))
    gram = a @ np.swapaxes(a, -1, -2)  # rank 4 of 6: needs jitter
    mat = {
        "clean": gram + np.eye(6),
        "escalates": gram - 1e-5 * np.eye(6),  # fails at 1e-6, passes at 1e-4
        "fails": -np.tile(np.eye(6), (3, 1, 1)),
    }[case]
    got = safe_cholesky(t(mat), 1e-6).numpy()
    want = np.asarray(jax_safe_cholesky(jnp.asarray(mat), 1e-6))
    if case == "fails":
        assert np.isnan(got).all() and not np.isfinite(want).all()
    else:
        assert np.isfinite(got).all()
        _close(got, want, rtol=1e-8, atol=1e-10)


def test_torch_paths_from_jax_draws_match_jax_paths():
    jm, tm = _pair(seed=6)
    key = jax.random.PRNGKey(11)
    want = jax.jit(jax_generate, static_argnums=(2, 3))(jm, key, 10, 16)
    draws = jax_path_draws(jm, key, 10, 16)
    got = paths_from_noise(tm, PathNoise(**{k: t(v) for k, v in draws.items()}))
    for name in ("omega", "phase", "w", "v"):
        _close(getattr(got, name), getattr(want, name), err_msg=name)


def test_torch_initializers_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(40, 3))
    _close(tinit.lengthscales_median(t(x)), jinit.lengthscales_median(jnp.asarray(x)))
    init = x[:5]
    _close(
        tinit._lloyd(t(x), t(init), 20),
        jinit._lloyd(jnp.asarray(x), jnp.asarray(init), num_clusters=5, num_iters=20),
    )
    pts = np.vstack([x[:6], x[:2] + 1e-4])
    np.testing.assert_array_equal(
        tinit.replace_duplicates(pts, 1.0, np.ones(3), tol=0.99),
        jinit.replace_duplicates(pts, 1.0, np.ones(3), tol=0.99),
    )


def test_torch_build_svgp_and_masks():
    rng = np.random.default_rng(8)
    x, y = t(rng.normal(size=(30, 6))), t(rng.normal(size=(30, 4)))
    gen = torch.Generator().manual_seed(0)
    model = build_svgp(x, y, num_inducing=12, generator=gen)
    assert model.z.shape == (4, 12, 6) and model.q_sqrt.shape == (4, 12, 12)
    assert model.q_mu.shape == (12, 4) and model.w is None
    _close(model.kernel.lengthscales[0], jinit.lengthscales_median(jnp.asarray(x.numpy())))
    small = build_svgp(x[:8], y[:8], num_inducing=12)
    torch.testing.assert_close(small.z[0], x[:8])  # M = N: the data itself

    trainable = dynamics_mask(model, freeze_inducing=True)
    assert not model.z.requires_grad and len(trainable) == 6
    trainable_ids = {id(p) for p in policy_mask(model)}
    names = {n for n, p in model.named_parameters() if id(p) in trainable_ids}
    assert names == {"z", "q_mu", "kernel.raw_lengthscales"}
    # 2 latents over the 4 outputs: coregionalized, w's rows of unit norm
    mixed = build_svgp(x, y, num_inducing=12, num_latent=2)
    assert mixed.w.shape == (4, 2) and mixed.z.shape == (2, 12, 6)
    torch.testing.assert_close(torch.linalg.norm(mixed.w, dim=-1), torch.ones(4, dtype=torch.float64))
