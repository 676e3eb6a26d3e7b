"""Moment-matching PILCO in the PyTorch port: the MM policy loss and its
gradient against the JAX package's ``MomentMatchingPILCO.policy_loss_fn``
in float64, with and without the pair-grid op and on the whole-match path
(the JAX side runs its Pallas kernels in interpret mode), tiny MM loop
iterations on the CPU, and the compensated loss mapped to float64."""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu import moments as jmom
from gpflowpilco_tpu.components import trigonometric_encoder as jax_encoder
from gpflowpilco_tpu.dynamics import forward as jforward
from gpflowpilco_tpu.dynamics import solvers as jsolvers
from gpflowpilco_tpu.loops.pilco import MomentMatchingPILCO as JaxMomentMatchingPILCO
from gpflowpilco_tpu.loops.pilco import PolicySpec as JaxPolicySpec
from gpflowpilco_tpu.moment_matching import rules as jrules
from gpflowpilco_tpu.moment_matching.gp import SVGPTransform as JaxSVGPTransform
from gpflowpilco_torch import moments as tmom
from gpflowpilco_torch.components import trigonometric_encoder
from gpflowpilco_torch.convert import svgp_from_numpy
from gpflowpilco_torch.dynamics import forward as tforward
from gpflowpilco_torch.dynamics import solvers as tsolvers
from gpflowpilco_torch.loops.pilco import DriftSpec, MomentMatchingPILCO, PolicySpec
from gpflowpilco_torch.models.builders import policy_mask
from gpflowpilco_torch.moment_matching import rules as trules
from gpflowpilco_torch.moment_matching.gp import SVGPTransform

from ._torch_export import CPU, jax_svgp, svgp_to_numpy, t

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
import experiment as jax_experiment  # noqa: E402
import run_torch  # noqa: E402

torch.set_num_threads(1)


def _jax_models(seed, dtype=jnp.float64):
    """A gentle drift (4 latents on the 5 features and the action) and a
    policy (1 latent on the 5 features)."""
    drift = jax_svgp(10 + seed, num_latent=4, m=8, d=6, dtype=dtype)
    drift = dataclasses.replace(drift, q_mu=0.2 * drift.q_mu)
    return drift, jax_svgp(20 + seed, num_latent=1, m=6, d=5, dtype=dtype)


def _flat(raw_lengthscales, z, q_mu):
    return np.concatenate([np.asarray(a).ravel() for a in (raw_lengthscales, z, q_mu)])


@pytest.mark.parametrize("fused", [False, True])
def test_torch_mm_policy_loss_and_grad_match_jax(fused):
    """The 10-step MM loss to rel 1e-8 and its gradient in the policy's raw
    parameters to cos >= 0.9999 with norm ratio within 1e-4, float64."""
    horizon = 1.0
    env, encoder, objective, spec = jax_experiment.build_task(jnp.float64, horizon=horizon)
    jloop = JaxMomentMatchingPILCO(
        env, spec, objective, encoder, dtype=jnp.float64,
        policy_spec=JaxPolicySpec(num_restarts=1, mm_unroll=1),  # one scan step to compile
    )
    jloop.use_fused_mm = fused
    jdrift, jpol = _jax_models(0)
    key = jax.random.PRNGKey(0)
    fn = jax.jit(jax.value_and_grad(lambda pm: jloop.policy_loss_fn(pm, key, drift=jdrift)))
    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grad = fn(jpol)

    tloop = run_torch.build_loop(
        0, CPU, torch.float64, policy_spec=PolicySpec(num_restarts=1), horizon=horizon,
        loop_cls=MomentMatchingPILCO,
    )
    tloop.use_fused_mm = fused
    tdrift = svgp_from_numpy(svgp_to_numpy(jdrift), CPU, torch.float64).requires_grad_(False)
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float64)
    policy_mask(tpol)
    loss = tloop.policy_loss_fn(tpol, None, drift=tdrift)
    loss.backward()

    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-8 * abs(float(want_loss))
    got = _flat(tpol.kernel.raw_lengthscales.grad, tpol.z.grad, tpol.q_mu.grad)
    want = _flat(want_grad.kernel.raw_lengthscales, want_grad.z, want_grad.q_mu)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    ratio = np.linalg.norm(got) / np.linalg.norm(want)
    assert np.linalg.norm(want) > 0
    assert cos >= 0.9999 and abs(ratio - 1.0) <= 1e-4, (cos, ratio)


def test_torch_mm_fused_match_loss_and_grad_match_jax():
    """``use_fused_match`` (whole-match drift and policy kernels, fused
    encoder, PSD guard and Euler update) against the JAX package's, both
    loops in float64 so that the whole-match path is on (the JAX kernels run
    in interpret mode): the 10-step loss to rel 1e-8, its policy gradient to
    cos >= 0.9999 with norm ratio within 1e-4."""
    horizon = 1.0
    env, encoder, objective, spec = jax_experiment.build_task(jnp.float64, horizon=horizon)
    jloop = JaxMomentMatchingPILCO(
        env, spec, objective, encoder, dtype=jnp.float64,
        policy_spec=JaxPolicySpec(num_restarts=1, mm_unroll=1),
    )
    jloop.use_fused_match = True
    assert jloop._fused_match_on
    jdrift, jpol = _jax_models(2)
    key = jax.random.PRNGKey(0)
    fn = jax.jit(jax.value_and_grad(lambda pm: jloop.policy_loss_fn(pm, key, drift=jdrift)))
    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grad = fn(jpol)

    tloop = run_torch.build_loop(
        0, CPU, torch.float64, policy_spec=PolicySpec(num_restarts=1), horizon=horizon,
        loop_cls=MomentMatchingPILCO,
    )
    tloop.use_fused_match = True
    assert tloop._fused_match_on
    tdrift = svgp_from_numpy(svgp_to_numpy(jdrift), CPU, torch.float64).requires_grad_(False)
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float64)
    policy_mask(tpol)
    loss = tloop.policy_loss_fn(tpol, None, drift=tdrift)
    loss.backward()

    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-8 * abs(float(want_loss))
    got = _flat(tpol.kernel.raw_lengthscales.grad, tpol.z.grad, tpol.q_mu.grad)
    want = _flat(want_grad.kernel.raw_lengthscales, want_grad.z, want_grad.q_mu)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    ratio = np.linalg.norm(got) / np.linalg.norm(want)
    assert np.linalg.norm(want) > 0
    assert cos >= 0.9999 and abs(ratio - 1.0) <= 1e-4, (cos, ratio)


def _state(seed, d=4):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(1, d, d))
    return np.array([[0.3, 2.8, -0.4, 0.6][:d]]), 0.05 * a @ a.transpose(0, 2, 1) + 0.02 * np.eye(d)


@pytest.mark.parametrize("case", ["drift", "policy", "encoder", "full"])
def test_torch_forward_moments_matches_jax(case):
    """The four compositions of forward_moments (drift alone, with a policy,
    with an encoder, with both) against the JAX package: the drift's output
    moments and Cov(x, f), and the gradient in the input covariance, f64."""
    use_enc, use_pol = case in ("encoder", "full"), case in ("policy", "full")
    d_feat = 5 if use_enc else 4
    jdrift = jax_svgp(51, num_latent=4, m=6, d=d_feat + (1 if use_pol else 0))
    jpol = jax_svgp(52, num_latent=1, m=5, d=d_feat)
    tdrift, tpol = (svgp_from_numpy(svgp_to_numpy(m), CPU, torch.float64) for m in (jdrift, jpol))
    jargs = dict(
        drift=JaxSVGPTransform(model=jdrift).with_cache(),
        policy=jmom.Chain(jrules.SquashedProbit(scale=jnp.asarray(19.99999)),
                          JaxSVGPTransform(model=jpol, deterministic=True).with_cache())
        if use_pol else None,
        encoder=jax_encoder((1,)) if use_enc else None,
    )
    targs = dict(
        drift=SVGPTransform(tdrift).with_cache(),
        policy=tmom.Chain(trules.SquashedProbit(scale=19.99999),
                          SVGPTransform(tpol, deterministic=True).with_cache())
        if use_pol else None,
        encoder=trigonometric_encoder((1,)) if use_enc else None,
    )
    mx, sxx = _state(53)
    w = np.random.default_rng(54).normal(size=(3, 4, 4))

    def jax_fn(s):
        m = jforward.forward_moments(jmom.GaussianMoments(mean=jnp.asarray(mx), cov=s), **jargs)
        outs = (m.y.mean, m.y.cov, m.cross_covariance(preinv=False))
        return sum(jnp.sum(wi * o) for wi, o in zip(w, outs)), outs

    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(jnp.asarray(sxx))
    ts = t(sxx).requires_grad_(True)
    m = tforward.forward_moments(tmom.GaussianMoments(t(mx), ts), **targs)
    outs = (m.y.mean, m.y.cov, m.cross_covariance(preinv=False))
    for got, ref in zip(outs, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)
    sum(torch.sum(t(wi) * o) for wi, o in zip(w, outs)).backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_grad), rtol=1e-8, atol=1e-11)


@pytest.mark.parametrize("cov_jitter", [None, 1e-3])
def test_torch_moment_matching_euler_rollout_matches_jax(cov_jitter):
    """Moment-matched Euler steps with a diffusion match (the noise branch)
    and, at cov_jitter 1e-3, the stop-gradient eigenvalue boost, against the
    JAX package in f64: every step's mean and covariance."""
    mx, sxx = _state(61, d=3)
    kw = dict(dt=0.5, num_steps=4, cov_jitter=cov_jitter)
    _, _, jmeans, jcovs = jsolvers.moment_matching_euler_rollout(
        lambda tt, x: jrules.Sin().moment_match(x),
        jmom.GaussianMoments(mean=jnp.asarray(mx), cov=jnp.asarray(sxx)),
        noise=lambda tt, x: jrules.Scale(jnp.asarray([0.3, -0.2, 0.1])).moment_match(x), **kw,
    )
    _, means, covs = tsolvers.moment_matching_euler_rollout(
        lambda tt, x: trules.Sin().moment_match(x),
        tmom.GaussianMoments(t(mx), t(sxx)),
        noise=lambda tt, x: trules.Scale(t([0.3, -0.2, 0.1])).moment_match(x), **kw,
    )
    assert means.shape == (4, 1, 3) and covs.shape == (4, 1, 3, 3)
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(covs.numpy(), np.asarray(jcovs), rtol=1e-12, atol=1e-14)


def _tiny_mm_loop(dtype=torch.float32, **policy):
    loop = run_torch.build_loop(
        3, CPU, dtype,
        drift_spec=DriftSpec(num_centers=6, max_iters=10, pad_data_multiple=0),
        policy_spec=PolicySpec(**{**dict(num_centers=5, step_limit=4, num_restarts=1), **policy}),
        horizon=0.6,  # 6 steps
        loop_cls=MomentMatchingPILCO,
    )
    loop.use_fused_mm = True
    return loop


def test_torch_mm_iteration_runs():
    """The production recipe at tiny size on the CPU: a float32 loop whose MM
    loss runs in float64 with the policy chain as a float32 island, through
    the pair-grid op; random episode, drift fit, policy update, RK4 episode."""
    loop = _tiny_mm_loop(loss_dtype=torch.float64)
    loop.step()
    info_d = loop.update_dynamics()
    assert np.isfinite(info_d["loss"])
    loop.policy_model = loop.build_policy()
    q0 = loop.policy_model.q_mu.detach().clone()
    info_p = loop.update_policy()
    assert np.isfinite(info_p["loss"]) and info_p["losses"].shape == (4,)
    assert info_p["skipped_steps"] == 0
    assert float((loop.policy_model.q_mu.detach() - q0).abs().max()) > 0
    assert all(p.dtype == torch.float32 for p in loop.policy_model.parameters())
    ep = loop.step()
    assert len(loop.episodes) == 2 and np.isfinite(ep.metrics["rewards"])
    assert np.isfinite(loop.expected_reward())


def test_torch_mm_fused_match_iteration_runs():
    """A float32 loop with ``use_fused_match`` at tiny size on the CPU (the
    kernel ops' plain versions): random episode, drift fit, policy update
    through the whole-match path, RK4 episode."""
    loop = _tiny_mm_loop()
    loop.use_fused_mm, loop.use_fused_match = False, True
    assert loop._fused_match_on
    loop.step()
    assert np.isfinite(loop.update_dynamics()["loss"])
    loop.policy_model = loop.build_policy()
    q0 = loop.policy_model.q_mu.detach().clone()
    info_p = loop.update_policy()
    assert np.isfinite(info_p["loss"]) and info_p["skipped_steps"] == 0
    assert float((loop.policy_model.q_mu.detach() - q0).abs().max()) > 0
    ep = loop.step()
    assert len(loop.episodes) == 2 and np.isfinite(ep.metrics["rewards"])


@pytest.mark.parametrize("policy_f32", [False, True])
def test_torch_mm_compensated_loss_is_the_float64_loss(policy_f32):
    """``loss_compensated`` (the JAX package's double-float loss) runs as the
    float64 loss here: the same value and gradient as ``loss_dtype=float64``
    under the same ``loss_policy_f32``, and not the float32 loss."""
    jdrift, jpol = _jax_models(1, dtype=jnp.float32)
    losses, grads = {}, {}
    for name, extra in (
        ("compensated", dict(loss_compensated=True)),
        ("f64", dict(loss_dtype=torch.float64)),
        ("f32", {}),
    ):
        loop = _tiny_mm_loop(loss_policy_f32=policy_f32, **extra)
        drift = svgp_from_numpy(svgp_to_numpy(jdrift), CPU, torch.float32).requires_grad_(False)
        pol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float32)
        policy_mask(pol)
        loss = loop.policy_loss_fn(pol, None, drift=drift)
        loss.backward()
        losses[name], grads[name] = loss.detach(), pol.q_mu.grad
    assert losses["compensated"].dtype == torch.float64
    assert torch.equal(losses["compensated"], losses["f64"])
    assert torch.equal(grads["compensated"], grads["f64"])
    assert losses["f32"].dtype == torch.float32
    assert float(losses["f32"]) != float(losses["f64"])
