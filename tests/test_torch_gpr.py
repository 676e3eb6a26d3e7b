"""The PyTorch port's exact GPR against the JAX package: the LML and its
gradient, predictions, the SNR penalty, an L-BFGS fit, the per-entry jitter
escalation of batched factorizations, and the GPR sample paths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.models.builders import build_gpr as jax_build_gpr
from gpflowpilco_tpu.models.gp import gpr_lml as jax_gpr_lml
from gpflowpilco_tpu.models.gp import gpr_predict_f as jax_gpr_predict_f
from gpflowpilco_tpu.models.pathwise import eval_paths_gpr as jax_eval_paths_gpr
from gpflowpilco_tpu.models.pathwise import generate_paths_gpr as jax_generate_paths_gpr
from gpflowpilco_tpu.models.priors import pilco_snr_penalty as jax_snr_penalty
from gpflowpilco_tpu.utils.optimizers import lbfgs_minimize as jax_lbfgs
from gpflowpilco_tpu.utils.trees import mask_from_names
from gpflowpilco_torch import config
from gpflowpilco_torch.convert import gpr_from_numpy, paths_from_numpy
from gpflowpilco_torch.models.builders import build_gpr, gpr_mask
from gpflowpilco_torch.models.gp import GPR, gpr_cholesky, gpr_lml, gpr_predict_f, gpr_stack
from gpflowpilco_torch.models.kernels import RBF
from gpflowpilco_torch.models.pathwise import eval_paths_gpr, generate_paths_gpr
from gpflowpilco_torch.models.priors import pilco_snr_penalty
from gpflowpilco_torch.ops.linalg import safe_cholesky_entrywise
from gpflowpilco_torch.utils import bijectors as bij
from gpflowpilco_torch.utils.optimizers import lbfgs_minimize

from ._torch_export import CPU, gpr_to_numpy, jax_gpr, jax_gpr_members, paths_to_numpy, t

torch.set_num_threads(1)


def _raw_grads(model):
    return np.concatenate([p.grad.numpy().ravel() for p in
                           (model.kernel.raw_variance, model.kernel.raw_lengthscales,
                            model.mean_const, model.raw_noise)])


def test_torch_gpr_lml_grad_and_prediction_match_jax():
    """gpr_lml, its gradient in the raw hyperparameters, and gpr_predict_f
    (marginal and full covariance), float64, rtol 1e-10."""
    jm = jax_gpr(0)
    want, wgrad = jax.value_and_grad(jax_gpr_lml)(jm)
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64)
    lml = gpr_lml(tm)
    lml.backward()
    np.testing.assert_allclose(float(lml.detach()), float(want), rtol=1e-10)
    wflat = np.concatenate([np.asarray(a).ravel() for a in (
        wgrad.kernel.raw_variance, wgrad.kernel.raw_lengthscales, wgrad.mean_const, wgrad.raw_noise)])
    np.testing.assert_allclose(_raw_grads(tm), wflat, rtol=1e-10, atol=1e-12)

    xs = np.random.default_rng(1).normal(size=(7, 4))
    with torch.no_grad():
        for full in (False, True):
            got = gpr_predict_f(tm, t(xs), full_cov=full)
            ref = jax_gpr_predict_f(jm, jnp.asarray(xs), full_cov=full)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-13)


def test_torch_stacked_gpr_matches_its_members():
    """A GPR stacked over 3 members gives each member's LML, prediction and
    SNR penalty, as the JAX package's vmap over members does."""
    jm = jax_gpr_members(2)
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64)
    assert tm.stacked and tm.x.shape == (30, 4)
    xs = jnp.asarray(np.random.default_rng(3).normal(size=(5, 4)))
    with torch.no_grad():
        np.testing.assert_allclose(gpr_lml(tm).numpy(), np.asarray(jax.vmap(jax_gpr_lml)(jm)),
                                   rtol=1e-10)
        np.testing.assert_allclose(
            gpr_predict_f(tm, t(xs))[0].numpy(),
            np.asarray(jax.vmap(lambda m: jax_gpr_predict_f(m, xs)[0])(jm)), rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(
            pilco_snr_penalty(tm).numpy(), np.asarray(jax.vmap(jax_snr_penalty)(jm)),
            rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("noise", [0.05, 1e-6])
def test_torch_gpr_snr_penalty_matches_jax(noise):
    """The SNR penalty of a GPR (atleast_1d of its scalar variance), exact
    to 1e-12; at noise 1e-6 the SNR passes the threshold and the penalty
    is far from zero."""
    jm = jax_gpr(4, noise=noise)
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64)
    with torch.no_grad():
        got = float(pilco_snr_penalty(tm))
    want = float(jax_snr_penalty(jm))
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
    assert (want < -1.0) == (noise < 1e-3)


def test_torch_gpr_lbfgs_fit_reaches_jax_lml():
    """The L-BFGS MAP fit (LML plus the SNR penalty, every hyperparameter
    trained, the data fixed) from build_gpr's start reaches the JAX fit's
    converged LML within 1e-6 relative."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 3))
    y = np.concatenate([np.sin(x[:, :1]), np.cos(x[:, 1:2]) * x[:, 2:]], -1) + 0.05 * rng.normal(size=(40, 2))

    def jloss(m):
        return -(jax_gpr_lml(m) + jax_snr_penalty(m))

    jstart = jax_build_gpr(x, y, noise_variance=0.1)
    jfit, _, _ = jax_lbfgs(jloss, jstart, max_iters=500, tol=1e-9,
                           mask=mask_from_names(jstart, lambda n: n not in ("x", "y")))
    want = float(jax_gpr_lml(jfit))

    tm = build_gpr(t(x), t(y), noise_variance=0.1)
    lbfgs_minimize(lambda: -(gpr_lml(tm) + pilco_snr_penalty(tm)), gpr_mask(tm), max_iters=500, tol=1e-9)
    with torch.no_grad():
        got = float(gpr_lml(tm))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_torch_entrywise_escalation_keeps_other_members():
    """A float32 batch of 3 GPRs on 200 duplicated inputs, the middle one at
    noise 1e-7 with a long lengthscale and a large variance, where
    chol(Knn + noise I + jitter I) fails: only that entry takes the raised
    jitter, the other two factors equal their unbatched ones bit for bit,
    and all are finite."""
    rng = np.random.default_rng(6)
    base = rng.normal(size=(200, 3))
    x = torch.as_tensor(np.concatenate([base, base]), dtype=torch.float32)
    y = torch.sin(x[:, :1])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    noises = f32([1e-2, 1e-7, 3e-2])
    var, ls = f32([1.0, 50.0, 1.0]), f32([[1.0] * 3, [5.0] * 3, [1.5] * 3])
    stacked = GPR(RBF.create(var, ls), x, y, torch.zeros((3, 1)), bij.positive_inv(noises))
    jit = config.default_jitter(torch.float32)
    eye = torch.eye(400)
    with torch.no_grad():
        chol = gpr_cholesky(stacked)
        assert torch.isfinite(chol).all()
        knn = stacked.kernel.gram(x)
        bad = torch.linalg.cholesky_ex(knn[1] + (stacked.noise_variance[1] + jit) * eye)[1]
        assert int(bad) != 0, "the tiny-noise member should need the escalation"
        for k in range(3):
            member = GPR(RBF.create(var[k], ls[k]), x, y, torch.zeros(1), bij.positive_inv(noises[k]))
            assert torch.equal(chol[k], gpr_cholesky(member))
        single = safe_cholesky_entrywise(knn[0] + stacked.noise_variance[0] * eye, jit)
        assert torch.equal(chol[0], single)
        assert torch.isfinite(gpr_lml(stacked)).all()


def test_torch_gpr_stack_builds_members_from_flat_draws():
    """gpr_stack turns (K, dim) flat hyperparameter rows, in named_parameters
    order, into a stacked GPR sharing the data."""
    tm = gpr_from_numpy(gpr_to_numpy(jax_gpr(7)), CPU, torch.float64)
    flat = torch.cat([p.detach().reshape(-1) for p in tm.parameters()])
    rows = torch.stack([flat, flat + 0.1])
    st = gpr_stack(tm, rows)
    assert st.stacked and st.x is tm.x
    with torch.no_grad():
        np.testing.assert_allclose(float(gpr_lml(st)[0]), float(gpr_lml(tm)), rtol=1e-14)
        np.testing.assert_allclose(st.mean_const[1].numpy(), tm.mean_const.detach().numpy() + 0.1)


@pytest.mark.parametrize("stacked", [False, True])
def test_torch_eval_paths_gpr_matches_jax(stacked):
    """eval_paths_gpr on JAX-generated paths, to 1e-12: one GPR, and 3
    stacked members against the JAX package's vmap."""
    key = jax.random.PRNGKey(8)
    x = np.random.default_rng(9).normal(size=(6, 4))
    if stacked:
        jm = jax_gpr_members(10)
        paths = jax.vmap(lambda m, k: jax_generate_paths_gpr(m, k, 6, 16))(jm, jax.random.split(key, 3))
        xs = np.stack([x, x + 0.3, x - 0.2])
        want = jax.vmap(jax_eval_paths_gpr)(jm, paths, jnp.asarray(xs))
    else:
        jm = jax_gpr(10)
        paths = jax_generate_paths_gpr(jm, key, 6, 16)
        xs = x
        want = jax_eval_paths_gpr(jm, paths, jnp.asarray(xs))
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64)
    with torch.no_grad():
        got = eval_paths_gpr(tm, paths_from_numpy(paths_to_numpy(paths), CPU, torch.float64), t(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_torch_generate_paths_gpr_matches_posterior():
    """Sample paths of a GPR reproduce its posterior mean and variance (the
    bars of tests/test_pathwise.py), and stacked members each their own."""
    rng = np.random.default_rng(11)
    n, d, p = 10, 2, 2
    x, y = rng.normal(size=(n, d)), rng.normal(size=(n, p))
    xt = 0.5 * rng.normal(size=(4, d))
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    gen = torch.Generator().manual_seed(12)
    model = GPR(RBF.create(f64([1.0, 0.7]), f64([[0.8, 0.8], [1.2, 0.6]])), f64(x), f64(y),
                f64([[0.0, 0.0], [0.1, -0.1]]), bij.positive_inv(f64([0.01, 0.03])))
    num_samples = 8000
    with torch.no_grad():
        paths = generate_paths_gpr(model, gen, num_samples, 1024)
        mean, var = gpr_predict_f(model, f64(xt))  # (K, 4, P)
        for i in range(xt.shape[0]):
            xi = f64(xt[i]).expand(2, num_samples, d)
            fi = eval_paths_gpr(model, paths, xi)  # (K, S, P)
            np.testing.assert_allclose(fi.mean(1).numpy(), mean[:, i].numpy(), atol=0.05)
            np.testing.assert_allclose(fi.var(1).numpy(), var[:, i].numpy(), atol=0.08)
