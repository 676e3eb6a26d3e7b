"""The port's linear-coregionalization (LCK) models held against the JAX
package in float64: coregionalized and shared-kernel SVGPs from JAX
``build_svgp`` (predictions, the ELBO and its gradients, down to the mixing
matrix and the shared lengthscales, 1e-10), the builder's mixing matrix and
inducing padding, ``match_svgp`` with a mixing matrix at the double
pendulum's drift shape through each of its routes (1e-9), and an LCK loop's
checkpoint round trip."""
import dataclasses
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.models import builders as jbuilders
from gpflowpilco_tpu.models import gp as jgp
from gpflowpilco_tpu.models.priors import pilco_snr_penalty as jax_snr
from gpflowpilco_tpu.moment_matching.gp import SVGPTransform as JaxSVGPTransform
from gpflowpilco_torch.convert import model_from_numpy, model_to_numpy, svgp_from_numpy
from gpflowpilco_torch.loops.pilco import DriftSpec, PathwisePILCO, PolicySpec
from gpflowpilco_torch.models import gp as tgp
from gpflowpilco_torch.models.builders import build_svgp, dynamics_mask, policy_mask
from gpflowpilco_torch.models.kernels import RBF, SharedRBF
from gpflowpilco_torch.models.priors import pilco_snr_penalty
from gpflowpilco_torch.moment_matching.gp import SVGPTransform

from ._torch_export import CPU, jax_svgp, svgp_to_numpy, t
from ._torch_tasks import load_example
from .test_torch_moment_matching import _compare_match, _moments

torch.set_num_threads(1)
TOL = dict(rtol=1e-10, atol=1e-12)

# (num_latent, shared_kernel) of the models exported from JAX build_svgp over
# 4 outputs: a mixed W (2 latents), the identity W (4) and the shared kernel
CASES = {"coreg2": (2, False), "coreg4": (4, False), "shared4": (4, True), "shared2": (2, True)}


def _data(seed, n=24, d=6, p=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, :p]) + 0.1 * rng.normal(size=(n, p))
    return x, y


def _jax_built(case, seed=0):
    """A JAX build_svgp model of ``case``, its q(u) and mean moved off the
    builder's zeros and identity by numpy draws, so every gradient is live."""
    num_latent, shared = CASES[case]
    x, y = _data(seed)
    jm = jbuilders.build_svgp(x, y, num_inducing=7, key=jax.random.PRNGKey(seed), coregionalize=True,
                              num_latent=num_latent, shared_kernel=shared, per_output_noise=True)
    rng = np.random.default_rng(seed + 1)
    m = jm.num_inducing
    q_sqrt = np.tril(0.1 * rng.normal(size=(num_latent, m, m))) + 0.5 * np.eye(m)
    return dataclasses.replace(
        jm, q_mu=jnp.asarray(0.5 * rng.normal(size=(m, num_latent))), q_sqrt=jnp.asarray(q_sqrt),
        mean_const=jnp.asarray(0.1 * rng.normal(size=y.shape[1])),
    ), x, y


@pytest.mark.parametrize("case", list(CASES))
def test_torch_lck_svgp_matches_jax(case):
    """predict_f (diagonal and full output covariance), the ELBO (plain, and
    with num_data and zero-weight rows) and the gradient of ELBO + SNR
    penalty in every raw parameter, w and the shared kernel's included."""
    jm, x, y = _jax_built(case)
    tm = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)
    assert isinstance(tm.kernel, SharedRBF) == CASES[case][1]
    assert tm.w.shape == (4, CASES[case][0])
    xs = np.random.default_rng(5).normal(size=(9, 6))
    for full in (False, True):
        got = tgp.svgp_predict_f(tm, t(xs), full_output_cov=full)
        want = jgp.svgp_predict_f(jm, jnp.asarray(xs), full_output_cov=full)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    weights = np.r_[np.ones(20), np.zeros(4)]
    np.testing.assert_allclose(
        float(tgp.svgp_elbo(tm, t(x), t(y), num_data=30, weights=t(weights)).detach()),
        float(jgp.svgp_elbo(jm, jnp.asarray(x), jnp.asarray(y), num_data=30, weights=jnp.asarray(weights))),
        **TOL,
    )

    def jax_obj(m):
        return jgp.svgp_elbo(m, jnp.asarray(x), jnp.asarray(y)) + jax_snr(m, 1e2, 4.0)

    want = jax.grad(jax_obj)(jm)
    loss = tgp.svgp_elbo(tm, t(x), t(y)) + pilco_snr_penalty(tm, 1e2, 4.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jax_obj(jm)), **TOL)
    for name, p in tm.named_parameters():
        w = want
        for part in name.split("."):
            w = getattr(w, part)
        assert p.grad.shape == w.shape, name
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), **TOL, err_msg=name)


def test_torch_shared_kernel_sums_latent_gradients():
    """A SharedRBF's gradient is the sum of the per-latent gradients of the
    same model with the shared values copied onto every latent."""
    jm, x, y = _jax_built("shared4")
    shared = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)
    d = svgp_to_numpy(jm)
    d.update(raw_variance=np.repeat(d["raw_variance"][None], 4), num_outputs=None,
             raw_lengthscales=np.repeat(d["raw_lengthscales"][None], 4, axis=0))
    separate = svgp_from_numpy(d, CPU, torch.float64)
    assert type(separate.kernel) is RBF
    for m in (shared, separate):
        tgp.svgp_elbo(m, t(x), t(y)).backward()
    for name in ("raw_variance", "raw_lengthscales"):
        got = getattr(shared.kernel, name).grad
        want = getattr(separate.kernel, name).grad.sum(0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14, err_msg=name)


def test_torch_build_svgp_coregionalized():
    """The builder's mixing matrix: the identity at P = L, unit-norm rows at
    L < P; coregionalize defaults on where L differs from P; the shared
    kernel stores one hyperparameter set; dynamics_mask trains w and
    policy_mask freezes it; L != P without coregionalize is refused."""
    x, y = (t(a) for a in _data(3))
    gen = torch.Generator().manual_seed(0)
    eye = build_svgp(x, y, num_inducing=8, generator=gen, coregionalize=True)
    torch.testing.assert_close(eye.w, torch.eye(4, dtype=torch.float64))
    mixed = build_svgp(x, y, num_inducing=8, generator=gen, num_latent=2)
    assert mixed.w.shape == (4, 2) and mixed.z.shape == (2, 8, 6) and mixed.q_mu.shape == (8, 2)
    torch.testing.assert_close(torch.linalg.norm(mixed.w, dim=-1), torch.ones(4, dtype=torch.float64))
    assert build_svgp(x, y, num_inducing=8, generator=gen).w is None
    shared = build_svgp(x, y, num_inducing=8, generator=gen, num_latent=2, shared_kernel=True)
    assert shared.kernel.raw_variance.shape == () and shared.kernel.raw_lengthscales.shape == (6,)
    assert shared.kernel.variance.shape == (2,) and shared.kernel.lengthscales.shape == (2, 6)

    trainable = {id(p) for p in dynamics_mask(mixed, freeze_inducing=False)}
    assert id(mixed.w) in trainable and mixed.w.requires_grad
    policy_mask(mixed)
    assert not mixed.w.requires_grad
    with pytest.raises(ValueError):
        build_svgp(x, y, num_inducing=8, coregionalize=False, num_latent=2)


@pytest.mark.parametrize("n, num_inducing, multiple, want_m", [(24, 40, 16, 32), (24, 30, 16, 30), (50, 40, 16, 40)])
def test_torch_pad_inducing_multiple(n, num_inducing, multiple, want_m):
    """pad_inducing_multiple rounds M up to the multiple, capped at
    num_inducing, as JAX build_svgp does; the two draw the extra points from
    different generators, so only the shape and that the points are distinct
    are held."""
    x, y = _data(4, n=n)
    jm = jbuilders.build_svgp(x, y, num_inducing=num_inducing, key=jax.random.PRNGKey(0),
                              pad_inducing_multiple=multiple)
    tm = build_svgp(t(x), t(y), num_inducing=num_inducing, generator=torch.Generator().manual_seed(0),
                    pad_inducing_multiple=multiple)
    assert tm.z.shape == jm.z.shape == (4, want_m, 6)
    assert tm.q_sqrt.shape == (4, want_m, want_m) and tm.q_mu.shape == (want_m, 4)
    z = tm.z[0].detach()
    gaps = torch.cdist(z, z) + torch.eye(want_m, dtype=z.dtype) * 1e9
    assert float(gaps.min()) > 1e-6
    assert torch.isfinite(tgp.chol_kuu(tm)).all()


# the double pendulum's drift: 6 features and 2 torques in, 4 latents mixed
# into 4 outputs; a small M
DP_D, DP_L, DP_P, DP_M = 8, 4, 4, 10


@pytest.mark.parametrize("route", ["unfused", "pair", "whole"])
def test_torch_match_svgp_dp_shape_matches_jax(route):
    """match_svgp of a mixed-W SVGP at the double pendulum's drift shape
    (D=8, L=4, P=4), with model uncertainty, through the unfused eKuffu,
    K2's plain version (the pair-grid op) and K3's plain version (the
    whole-match op), against JAX match_svgp: mean, cov and cross to 1e-9,
    their gradient in the input moments to 1e-8."""
    jm = jax_svgp(51, num_latent=DP_L, m=DP_M, d=DP_D, num_out=DP_P)
    tm = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)
    mx, sxx = _moments(52, DP_D)
    jt = JaxSVGPTransform(model=jm).with_cache()
    tt = SVGPTransform(tm, fused=route == "pair", fused_match=route == "whole").with_cache()
    assert (tt.cache.fused_grid is not None) == (route == "pair")
    assert (tt.cache.match_grid is not None) == (route == "whole")
    with pltpu.force_tpu_interpret_mode():
        _compare_match(jt.moment_match, tt.moment_match, mx, sxx, 1e-9, 1e-8)


def test_torch_lck_checkpoint_round_trip():
    """A double-pendulum loop with a shared-kernel LCK drift (4 outputs from
    2 latents) and an LCK policy, saved after an iteration and restored into
    a fresh loop: w and the shared kernel come back bit for bit, the drift
    still trains w, and the restored policies keep w frozen."""
    dp = load_example("double_pendulum")
    with tempfile.TemporaryDirectory() as tmp:
        def make():
            return dp.build_loop(
                3, CPU, torch.float64,
                drift_spec=DriftSpec(num_centers=8, max_iters=5, pad_data_multiple=0, num_latent=2,
                                     shared_kernel=True),
                policy_spec=PolicySpec(num_centers=5, step_limit=3, batch_size=6, num_bases=8,
                                       num_restarts=1, action_scale=2.0, coregionalize=True),
                horizon=0.3, loop_cls=PathwisePILCO, directory=tmp, validation_samples=0,
            )

        loop = make()
        loop.step()
        loop.update_dynamics()
        loop.update_policy()
        loop.step()
        loop.save()
        assert isinstance(loop.drift_model.kernel, SharedRBF) and loop.drift_model.w.shape == (4, 2)
        back = make()
        assert len(back.episodes) == 2
        for a, b in ((loop.drift_model, back.drift_model), (loop.policy_model, back.policy_model),
                     (loop.best_policy_model, back.best_policy_model)):
            assert type(a.kernel) is type(b.kernel)
            for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
                assert na == nb and torch.equal(pa, pb), na
        assert back.policy_model.w.shape == (2, 2) and not back.policy_model.w.requires_grad
        assert not back.best_policy_model.w.requires_grad
        assert back.drift_model.w.requires_grad
        d = model_to_numpy(back.drift_model)
        assert d["num_outputs"] == 2 and isinstance(model_from_numpy(d, CPU, torch.float64).kernel, SharedRBF)
