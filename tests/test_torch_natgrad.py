"""The port's natural-gradient update of q(u) and its two new drift fits,
held against the JAX package in float64: ``natgrad_step`` (1e-10), its
conjugate one-step optimality (the twin of tests/test_training.py's), and
the loop's 'natgrad_adam' and minibatched 'adam' fits (the twins of
tests/test_loops.py's)."""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.models import natgrad as jnat
from gpflowpilco_torch.convert import svgp_from_numpy
from gpflowpilco_torch.loops.pilco import DriftSpec, MomentMatchingPILCO, PolicySpec
from gpflowpilco_torch.models import natgrad as tnat
from gpflowpilco_torch.models.builders import build_svgp
from gpflowpilco_torch.models.gp import SVGP, svgp_elbo
from gpflowpilco_torch.models.kernels import RBF
from gpflowpilco_torch.models.initializers import inducing_points_kmeans, lengthscales_median
from gpflowpilco_torch.utils import bijectors as bij

from ._torch_export import CPU, jax_svgp, svgp_to_numpy, t

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
import run_torch  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-10, atol=1e-12)


def _data(seed, n=20, d=4, p=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    return x, np.sin(x[:, :p]) + 0.1 * rng.normal(size=(n, p))


@pytest.mark.parametrize("whiten, num_out, weighted", [(True, None, False), (False, None, True), (True, 3, True)])
def test_torch_natgrad_step_matches_jax(whiten, num_out, weighted):
    """One step at gamma=0.7 (with num_data and zero-weight rows where
    ``weighted``), whitened or not, with and without a mixing matrix: the
    new q_mu and q_sqrt, and _elbo_meanvar at the old ones, to 1e-10."""
    num_latent = 2 if num_out else 3
    jm = jax_svgp(61, num_latent=num_latent, m=6, d=4, whiten=whiten, num_out=num_out)
    tm = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)
    x, y = _data(62)
    kw = {}
    if weighted:
        kw = dict(num_data=30, weights=np.r_[np.ones(15), np.zeros(5)])
    jkw = {k: jnp.asarray(v) if k == "weights" else v for k, v in kw.items()}
    tkw = {k: t(v) if k == "weights" else v for k, v in kw.items()}
    m = np.asarray(jm.q_mu).T
    q = np.tril(np.asarray(jm.q_sqrt))
    s = q @ np.swapaxes(q, -1, -2)
    want = jnat._elbo_meanvar(jm, jnp.asarray(m), jnp.asarray(s), jnp.asarray(x), jnp.asarray(y), **jkw)
    got = tnat._elbo_meanvar(tm, t(m), t(s), t(x), t(y), **tkw)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    jm1 = jnat.natgrad_step(jm, jnp.asarray(x), jnp.asarray(y), gamma=0.7, **jkw)
    out = tnat.natgrad_step(tm, t(x), t(y), gamma=0.7, **tkw)
    assert out is tm
    np.testing.assert_allclose(tm.q_mu.detach().numpy(), np.asarray(jm1.q_mu), **TOL)
    np.testing.assert_allclose(tm.q_sqrt.detach().numpy(), np.asarray(jm1.q_sqrt), **TOL)
    assert tm.kernel.raw_lengthscales.grad is None  # no gradient reaches the other parameters


@pytest.mark.parametrize("whiten", [True, False])
def test_torch_natgrad_one_step_optimal_gaussian_likelihood(whiten):
    """Conjugate case: one step at gamma=1 reaches the exact optimal q(u);
    a second step changes nothing."""
    rng = np.random.default_rng(31)
    n, d, m = 60, 2, 12
    x = t(rng.uniform(-2, 2, size=(n, d)))
    y = torch.sin(x[:, :1]) + 0.1 * t(rng.normal(size=(n, 1)))
    z0 = inducing_points_kmeans(x, m, generator=torch.Generator().manual_seed(0))
    model = SVGP(
        kernel=RBF.create(torch.ones(1, dtype=torch.float64), lengthscales_median(x)[None]),
        z=z0[None],
        q_mu=torch.zeros((m, 1), dtype=torch.float64),
        q_sqrt=torch.eye(m, dtype=torch.float64)[None],
        mean_const=torch.zeros(1, dtype=torch.float64),
        raw_noise=bij.positive_inv(torch.tensor(0.05, dtype=torch.float64)),
        whiten=whiten,
    )
    elbo = lambda: float(svgp_elbo(model, x, y).detach())  # noqa: E731
    e0 = elbo()
    tnat.natgrad_step(model, x, y, gamma=1.0)
    e1 = elbo()
    tnat.natgrad_step(model, x, y, gamma=1.0)
    e2 = elbo()
    assert e1 > e0 + 1.0, (e0, e1)
    assert abs(e2 - e1) < 1e-6 * max(1.0, abs(e1)), (e1, e2)


def _tiny_loop(seed):
    """The tiny MM loop of tests/test_loops.py (8-step horizon), float64."""
    return run_torch.build_loop(
        seed, CPU, torch.float64,
        drift_spec=DriftSpec(num_centers=6, max_iters=10, pad_data_multiple=0),
        policy_spec=PolicySpec(num_centers=5, step_limit=10, batch_size=8, num_bases=16, num_restarts=2),
        horizon=0.8, loop_cls=MomentMatchingPILCO,
    )


@pytest.mark.parametrize("pad", [0, 16])
def test_torch_dynamics_fit_natgrad_adam(pad):
    """DriftSpec.optimizer='natgrad_adam' on one episode: 10 rounds, a
    finite loss, a sane ELBO, and q(u) at the conjugate optimum for the
    fitted hyperparameters (one more natural-gradient step moves the ELBO by
    less than 1e-6 relative); with pad > 0 the zero-weight padding rows do
    not enter."""
    loop = _tiny_loop(12)
    loop.drift_spec = DriftSpec(num_centers=8, max_iters=100, optimizer="natgrad_adam", hyper_lr=0.05,
                                pad_data_multiple=pad)
    loop.step()
    info = loop.update_dynamics()
    assert np.isfinite(info["loss"]) and info["iters"] == 10
    x, y = loop.get_data_dynamics()
    model = loop.drift_model
    e1 = float(svgp_elbo(model, x, y).detach())
    assert np.isfinite(e1)
    tnat.natgrad_step(model, x, y)
    e2 = float(svgp_elbo(model, x, y).detach())
    assert abs(e2 - e1) < 1e-6 * max(1.0, abs(e1)), (e1, e2)


def test_torch_dynamics_fit_minibatched_adam_matches_lbfgs():
    """DriftSpec.optimizer='adam' (minibatched stochastic ELBO) lands within
    a few nats per datum of the full-batch L-BFGS fit on the same data, and
    reruns of the same iteration draw the same batches."""
    loop = _tiny_loop(17)
    loop.step()
    x, y = loop.get_data_dynamics()
    loop.drift_spec = DriftSpec(num_centers=6, max_iters=60, pad_data_multiple=0)
    loop.update_dynamics()
    elbo_lbfgs = float(svgp_elbo(loop.drift_model, x, y).detach())
    adam = DriftSpec(num_centers=6, max_iters=800, optimizer="adam", adam_lr=0.03, batch_size=64,
                     pad_data_multiple=0)
    fits = []
    for _ in range(2):
        loop.drift_model = None  # a fresh build for the adam fit
        loop.drift_spec = adam
        info = loop.update_dynamics()
        assert np.isfinite(info["loss"]) and info["iters"] == 800
        fits.append(loop.drift_model)
    elbo_adam = float(svgp_elbo(loop.drift_model, x, y).detach())
    assert np.isfinite(elbo_lbfgs) and np.isfinite(elbo_adam)
    assert elbo_adam >= elbo_lbfgs - 3.0 * x.shape[0], (elbo_adam, elbo_lbfgs)
    for a, b in zip(fits[0].parameters(), fits[1].parameters()):
        assert torch.equal(a, b)


def test_torch_drift_optimizer_names():
    """An SVGP drift takes 'lbfgs', 'adam' or 'natgrad_adam'; 'hmc' needs a
    GPR, and any other name is refused."""
    loop = _tiny_loop(5)
    loop.step()
    for name, err in (("hmc", ValueError), ("sgd", ValueError)):
        loop.drift_spec = DriftSpec(optimizer=name, num_centers=6, max_iters=5, pad_data_multiple=0)
        with pytest.raises(err):
            loop.update_dynamics()
    x, y = (t(a) for a in _data(7))
    assert build_svgp(x, y, num_inducing=4, num_latent=2).w.shape == (3, 2)
