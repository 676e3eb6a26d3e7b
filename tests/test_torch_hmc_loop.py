"""Slice B in the PyTorch port: GPR and HMC-ensemble drifts in both loop
classes. The ensemble MM loss and its policy gradient against the JAX
package's in float64 (unfused, through the pair grid and on the whole-match
path; the JAX Pallas kernels in interpret mode), the single GPR MAP drift,
the pathwise ensemble loss on the JAX package's own paths and initial
states, and tiny loop iterations with ``optimizer='hmc'``."""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.loops.pilco import MomentMatchingPILCO as JaxMomentMatchingPILCO
from gpflowpilco_tpu.loops.pilco import PathwisePILCO as JaxPathwisePILCO
from gpflowpilco_tpu.loops.pilco import PolicySpec as JaxPolicySpec
from gpflowpilco_tpu.models.gp import GPREnsemble as JaxGPREnsemble
from gpflowpilco_tpu.models.pathwise import generate_paths_gpr as jax_generate_paths_gpr
from gpflowpilco_torch.convert import gpr_ensemble_from_numpy, gpr_from_numpy, paths_from_numpy, svgp_from_numpy
from gpflowpilco_torch.loops.pilco import DriftSpec, MomentMatchingPILCO, PathwisePILCO, PolicySpec
from gpflowpilco_torch.models.builders import policy_mask
from gpflowpilco_torch.models.gp import GPREnsemble
from gpflowpilco_torch.models.pathwise import PathwiseGPRTransform

from ._torch_export import CPU, gpr_to_numpy, jax_gpr, jax_gpr_members, jax_svgp, paths_to_numpy, svgp_to_numpy, t

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
import experiment as jax_experiment  # noqa: E402
import run_torch  # noqa: E402

torch.set_num_threads(1)


def _gentle(m):
    """The drift's targets scaled down, so a short rollout stays near x0."""
    return dataclasses.replace(m, y=0.2 * m.y)


def _models(seed, ensemble):
    """A GPR drift on the 5 features and the action (4 outputs), stacked over
    3 members for an ensemble, and a policy (1 latent on the 5 features)."""
    if ensemble:
        drift = JaxGPREnsemble(members=_gentle(jax_gpr_members(seed, n=24, d=6, p=4)), num_members=3)
    else:
        drift = _gentle(jax_gpr(seed, n=24, d=6, p=4))
    return drift, jax_svgp(seed + 1, num_latent=1, m=6, d=5)


def _torch_drift(jdrift):
    if isinstance(jdrift, JaxGPREnsemble):
        return gpr_ensemble_from_numpy(gpr_to_numpy(jdrift.members), CPU, torch.float64).requires_grad_(False)
    return gpr_from_numpy(gpr_to_numpy(jdrift), CPU, torch.float64).requires_grad_(False)


def _flat(raw_lengthscales, z, q_mu):
    return np.concatenate([np.asarray(a).ravel() for a in (raw_lengthscales, z, q_mu)])


def _check(loss, want_loss, tpol, want_grad):
    """Loss to 1e-8 relative; the policy gradient to cos >= 0.9999 and a
    norm ratio within 1e-4."""
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-8 * abs(float(want_loss))
    got = _flat(tpol.kernel.raw_lengthscales.grad, tpol.z.grad, tpol.q_mu.grad)
    want = _flat(want_grad.kernel.raw_lengthscales, want_grad.z, want_grad.q_mu)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    ratio = np.linalg.norm(got) / np.linalg.norm(want)
    assert np.linalg.norm(want) > 0
    assert cos >= 0.9999 and abs(ratio - 1.0) <= 1e-4, (cos, ratio)


@pytest.mark.parametrize("mode,ensemble", [
    ("unfused", True), ("fused_mm", True), ("fused_match", True), ("unfused", False),
])
def test_torch_gpr_mm_loss_and_grad_match_jax(mode, ensemble):
    """The 5-step MM loss under a 3-member GPREnsemble (posterior-averaged:
    the JAX package vmaps one rollout per member, the port runs one rollout
    with the members as its batch) or a single GPR MAP drift, float64, with
    the loop's kernel routes as named."""
    horizon = 0.5
    env, encoder, objective, spec = jax_experiment.build_task(jnp.float64, horizon=horizon)
    jloop = JaxMomentMatchingPILCO(
        env, spec, objective, encoder, dtype=jnp.float64,
        policy_spec=JaxPolicySpec(num_restarts=1, mm_unroll=1),
    )
    jloop.use_fused_mm = mode == "fused_mm"
    jloop.use_fused_match = mode == "fused_match"
    jdrift, jpol = _models(30, ensemble)
    key = jax.random.PRNGKey(0)
    fn = jax.jit(jax.value_and_grad(lambda pm: jloop.policy_loss_fn(pm, key, drift=jdrift)))
    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grad = fn(jpol)

    tloop = run_torch.build_loop(
        0, CPU, torch.float64, policy_spec=PolicySpec(num_restarts=1), horizon=horizon,
        loop_cls=MomentMatchingPILCO,
    )
    tloop.use_fused_mm = mode == "fused_mm"
    tloop.use_fused_match = mode == "fused_match"
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float64)
    policy_mask(tpol)
    loss = tloop.policy_loss_fn(tpol, None, drift=_torch_drift(jdrift))
    loss.backward()
    _check(loss, want_loss, tpol, want_grad)


def test_torch_gpr_pathwise_ensemble_loss_and_grad_match_jax():
    """The pathwise loss under a 3-member ensemble (12 particles, 4 per
    member, each riding its member's paths) on the JAX package's own paths
    and initial states: loss to 1e-8 relative, gradient cos >= 0.9999."""
    horizon = 0.5
    env, encoder, objective, spec = jax_experiment.build_task(jnp.float64, horizon=horizon)
    pspec = JaxPolicySpec(num_restarts=1, batch_size=12, num_bases=16)
    jloop = JaxPathwisePILCO(env, spec, objective, encoder, dtype=jnp.float64, policy_spec=pspec)
    jdrift, jpol = _models(31, ensemble=True)
    key = jax.random.PRNGKey(1)
    fn = jax.jit(jax.value_and_grad(lambda pm: jloop.policy_loss_fn(pm, key, drift=jdrift)))
    want_loss, want_grad = fn(jpol)

    # the draws the JAX loss makes (pilco.py, PathwisePILCO.policy_loss_fn)
    paths, x0 = [], []
    for k, kk in enumerate(jax.random.split(key, 3)):
        k_paths, k_init = jax.random.split(kk)
        member = jax.tree.map(lambda a, k=k: a[k], jdrift.members)
        paths.append(jax_generate_paths_gpr(member, k_paths, 4, 16))
        x0.append(np.asarray(spec.sample(k_init, (4,))))
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *paths)

    tloop = run_torch.build_loop(
        0, CPU, torch.float64, horizon=horizon,
        policy_spec=PolicySpec(num_restarts=1, batch_size=12, num_bases=16),
    )
    tdrift = _torch_drift(jdrift)
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float64)
    policy_mask(tpol)
    drift_fn = PathwiseGPRTransform(tdrift.members, paths_from_numpy(paths_to_numpy(stacked), CPU, torch.float64))
    loss = tloop._particle_rollout_loss(tpol, drift_fn, t(np.concatenate(x0)))
    loss.backward()
    _check(loss, want_loss, tpol, want_grad)


def _tiny_loop(cls, **drift):
    return run_torch.build_loop(
        11, CPU, torch.float32,
        drift_spec=DriftSpec(**{**dict(
            model_type="gpr", optimizer="hmc", max_iters=15, hmc_chains=2, hmc_warmup=10,
            hmc_samples=10, hmc_leapfrog=4, hmc_ensemble=3), **drift}),
        policy_spec=PolicySpec(num_centers=5, step_limit=4, batch_size=9, num_bases=16, num_restarts=1),
        horizon=0.5,  # 5 steps
        loop_cls=cls,
    )


@pytest.mark.parametrize("cls,route", [
    (MomentMatchingPILCO, "fused_match"), (MomentMatchingPILCO, "fused_mm"), (PathwisePILCO, None),
])
def test_torch_hmc_ensemble_loop_iteration(cls, route):
    """DriftSpec(model_type='gpr', optimizer='hmc') at tiny size on the CPU:
    random episode, MAP fit, HMC ensemble of 3 members, policy update, RK4
    episode whose eReward metric runs the loss under no_grad. The pathwise
    loop runs ChEES."""
    loop = _tiny_loop(cls, hmc_adapt="chees" if cls is PathwisePILCO else "jitter")
    if route == "fused_match":
        loop.use_fused_match = True
    elif route == "fused_mm":
        loop.use_fused_mm = True
        loop.policy_spec = dataclasses.replace(loop.policy_spec, loss_dtype=torch.float64)
    loop.step()
    info = loop.update_dynamics()
    assert isinstance(loop.drift_model, GPREnsemble) and loop.drift_model.num_members == 3
    assert loop.drift_model.members.x.shape == (5, 6)
    assert np.isfinite(info["loss"]) and 0.0 <= info["hmc_accept"] <= 1.0
    loop.policy_model = loop.build_policy()
    info_p = loop.update_policy()
    assert np.isfinite(info_p["loss"])
    ep = loop.step()
    assert len(loop.episodes) == 2
    assert np.isfinite(ep.metrics["rewards"]) and np.isfinite(ep.metrics["eReward"])
    # the next refit starts from a fresh point model
    loop.update_dynamics()
    assert loop.drift_model.members.x.shape == (10, 6)


def test_torch_gpr_map_drift_loop_iteration():
    """A single GPR drift fit by L-BFGS (model_type='gpr', optimizer='lbfgs')
    drives the MM loss through the whole-match path."""
    loop = _tiny_loop(MomentMatchingPILCO, optimizer="lbfgs")
    loop.use_fused_match = True
    loop.step()
    info = loop.update_dynamics()
    assert np.isfinite(info["loss"]) and not loop.drift_model.stacked
    loop.policy_model = loop.build_policy()
    assert np.isfinite(loop.update_policy()["loss"])


def test_torch_hmc_requires_a_gpr_drift():
    loop = _tiny_loop(PathwisePILCO, model_type="svgp")
    loop.step()
    with pytest.raises(ValueError, match="model_type='gpr'"):
        loop.update_dynamics()
