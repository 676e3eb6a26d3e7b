"""The double-pendulum and mountain-car tasks of the port held against the
JAX package in float64: the environments' ODEs (1e-12) and RK4 episodes
(1e-10), the success masks, the double pendulum's 6-step pathwise and
moment-matched losses at an exported LCK state through each route (1e-9
relative), one PILCO iteration of each task in both loop classes (the twins
of tests/test_loops.py), the runners' full-run specs and the renderer."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.envs import base as jbase
from gpflowpilco_tpu.envs.double_pendulum import DoublePendulum as JaxDoublePendulum
from gpflowpilco_tpu.envs.mountain_car import MountainCar as JaxMountainCar
from gpflowpilco_tpu.loops.pilco import DriftSpec as JaxDriftSpec
from gpflowpilco_tpu.loops.pilco import MomentMatchingPILCO as JaxMomentMatchingPILCO
from gpflowpilco_tpu.loops.pilco import PathwisePILCO as JaxPathwisePILCO
from gpflowpilco_tpu.loops.pilco import PolicySpec as JaxPolicySpec
from gpflowpilco_tpu.models.pathwise import generate_paths_svgp as jax_generate_paths
from gpflowpilco_torch.convert import paths_from_numpy, svgp_from_numpy
from gpflowpilco_torch.envs import base as tbase
from gpflowpilco_torch.envs.cartpole import CartPole
from gpflowpilco_torch.envs.double_pendulum import DoublePendulum
from gpflowpilco_torch.envs.mountain_car import MountainCar
from gpflowpilco_torch.loops.pilco import DriftSpec, MomentMatchingPILCO, PathwisePILCO, PolicySpec
from gpflowpilco_torch.models.builders import policy_mask
from gpflowpilco_torch.models.pathwise import PathwiseSVGPTransform

from ._torch_export import CPU, jax_svgp, paths_to_numpy, svgp_to_numpy, t
from ._torch_tasks import load_example

torch.set_num_threads(1)
ENVS = {"double_pendulum": (DoublePendulum, JaxDoublePendulum), "mountain_car": (MountainCar, JaxMountainCar)}


def _states_actions(task, seed, shape=(16,)):
    rng = np.random.default_rng(seed)
    if task == "double_pendulum":
        x = np.pi + rng.uniform(-3.0, 3.0, size=shape + (2,))
        v = rng.normal(scale=3.0, size=shape + (2,))
        return np.concatenate([x, v], -1), rng.uniform(-2.5, 2.5, size=shape + (2,))
    # both sides of the curve's kink at 0 and the clipped walls at +-1.5
    x = rng.uniform(-1.6, 1.6, size=shape + (1,))
    return np.concatenate([x, rng.normal(size=shape + (1,))], -1), rng.uniform(-5.0, 5.0, size=shape + (1,))


@pytest.mark.parametrize("task", list(ENVS))
def test_torch_env_ode_matches_jax(task):
    env, jenv = (cls() for cls in ENVS[task])
    state, action = _states_actions(task, 1)
    np.testing.assert_allclose(env.ode(t(state), t(action)).numpy(),
                               np.asarray(jenv.ode(jnp.asarray(state), jnp.asarray(action))),
                               rtol=1e-12, atol=1e-12)
    if task == "mountain_car":
        xs = state[:, 0]
        np.testing.assert_allclose(env.height(t(xs)).numpy(), np.asarray(jenv.height(jnp.asarray(xs))),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("task", list(ENVS))
def test_torch_env_episode_matches_jax(task):
    """A 10-step episode of env_step (RK4, 10 substeps, clipped actions)
    from seeded states and actions, to 1e-10."""
    env, jenv = (cls() for cls in ENVS[task])
    state, _ = _states_actions(task, 2, shape=(4,))
    _, actions = _states_actions(task, 3, shape=(10, 4))
    dt = 0.05 if task == "double_pendulum" else 0.1
    got, want = t(state), jnp.asarray(state)
    for a in actions:
        got = tbase.env_step(env, got, t(a), dt)
        want = jbase.env_step(jenv, want, jnp.asarray(a), dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)


def test_torch_env_resets_and_vertices():
    dp, mc = DoublePendulum(), MountainCar()
    gen = torch.Generator().manual_seed(0)
    x = torch.stack([dp.reset(gen, dtype=torch.float64) for _ in range(200)])
    assert x.shape == (200, 4) and float((x[:, :2] - np.pi).abs().max()) < 0.06
    c = torch.stack([mc.reset(gen, dtype=torch.float64) for _ in range(200)])
    assert float(c[:, 0].min()) >= -0.6 and float(c[:, 0].max()) <= -0.4 and not c[:, 1].any()
    state, _ = _states_actions("double_pendulum", 4)
    got = dp.get_vertex_coordinates(t(state))
    want = JaxDoublePendulum().get_vertex_coordinates(jnp.asarray(state))
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)


def test_torch_success_masks_match_jax():
    """The double pendulum's hold-in-seconds mask (at two control rates)
    and mountain car's, on batches of trajectories against JAX's."""
    jdp, tdp = load_example("double_pendulum", "experiment"), load_example("double_pendulum")
    jmc, tmc = load_example("mountain_car", "experiment"), load_example("mountain_car")
    rng = np.random.default_rng(5)
    # the outer tip near the goal for a random stretch of each trajectory
    states = np.zeros((40, 31, 4))
    states[..., :2] = rng.uniform(-0.3, 0.3, size=(40, 31, 2))
    for i in range(40):
        a = rng.integers(0, 31)
        states[i, a:a + rng.integers(0, 20), :2] += 1.0
    env, jenv = DoublePendulum(), JaxDoublePendulum()
    for step in (0.05, 0.1):
        got = tdp.success_mask(env, t(states), step)
        want = [bool(jdp.success_mask(jenv, jnp.asarray(s), step)) for s in states]
        assert got.tolist() == want and 0 < sum(want) < 40
    cars = np.zeros((40, 51, 2))
    cars[..., 0] = 0.6 + rng.choice([0.02, 0.2], size=(40, 51))
    got = tmc.success_mask(t(cars))
    want = [bool(jmc.success_mask(jnp.asarray(s))) for s in cars]
    assert got.tolist() == want and 0 < sum(want) < 40


# ---------------------------------------------------------------- the 6-step losses
S, B = 16, 32
DRIFT_M, POLICY_M = 12, 8


def _dp_state(seed=21):
    """An LCK drift over the 6 features and 2 torques (4 latents mixed into 4
    outputs, q_mu scaled down so 6 steps stay near the start) and an LCK
    policy (2 latents mixed into 2 torques), as JAX models."""
    drift = jax_svgp(seed, num_latent=4, m=DRIFT_M, d=8, num_out=4)
    drift = drift.__class__(**{**drift.__dict__, "q_mu": 0.3 * drift.q_mu, "w": 0.5 * drift.w})
    return drift, jax_svgp(seed + 1, num_latent=2, m=POLICY_M, d=6, num_out=2)


def _dp_loops(loop_cls, jax_cls):
    specs = dict(num_centers=POLICY_M, batch_size=S, num_bases=B, num_restarts=1, action_scale=2.0,
                 coregionalize=True)
    jloop = load_example("double_pendulum", "experiment").build_loop(
        jax_cls, None, seed=7, dtype=jnp.float64, policy_spec=JaxPolicySpec(**specs), horizon=0.6,
        validation_samples=0)
    tloop = load_example("double_pendulum").build_loop(
        7, CPU, torch.float64, policy_spec=PolicySpec(**specs), horizon=0.6, loop_cls=loop_cls,
        validation_samples=0)
    assert tloop.episode_spec.num_steps == jloop.episode_spec.num_steps == 6
    return jloop, tloop


def _torch_models(jdrift, jpol):
    tdrift = svgp_from_numpy(svgp_to_numpy(jdrift), CPU, torch.float64).requires_grad_(False)
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float64)
    policy_mask(tpol)
    return tdrift, tpol


@pytest.mark.parametrize("route", ["unfused", "paths", "rollout"])
def test_torch_dp_pathwise_loss_matches_jax(route):
    """The 6-step pathwise loss at the exported state and the same paths and
    x0 as JAX's policy_loss_fn draws: per step through the plain drift
    paths, through K1's plain version (use_fused_paths), and as the whole
    rollout through K6's plain version (use_fused_rollout); 1e-9 relative."""
    jloop, tloop = _dp_loops(PathwisePILCO, JaxPathwisePILCO)
    jdrift, jpol = _dp_state()
    key = jax.random.PRNGKey(3)
    want = float(jloop.policy_loss_fn(jpol, key, drift=jdrift))
    k_paths, k_init = jax.random.split(key)
    paths = paths_from_numpy(paths_to_numpy(jax_generate_paths(jdrift, k_paths, S, B)), CPU, torch.float64)
    x0 = t(jloop.episode_spec.sample(k_init, (S,)))
    tdrift, tpol = _torch_models(jdrift, jpol)
    tloop.use_fused_paths = route == "paths"
    tloop.use_fused_rollout = route == "rollout"
    assert tloop._fused_rollout_eligible(tdrift, tpol) == (route == "rollout")
    if route == "rollout":
        got = tloop._fused_rollout_loss(tpol, tdrift, paths, x0)
    else:
        got = tloop._particle_rollout_loss(
            tpol, PathwiseSVGPTransform(model=tdrift, paths=paths, fused=route == "paths"), x0)
    got = float(got.detach())
    assert abs(got - want) <= 1e-9 * abs(want), (got, want)


@pytest.mark.parametrize("route", ["unfused", "pair", "whole"])
def test_torch_dp_mm_loss_matches_jax(route):
    """The 6-step moment-matched loss at the exported state against JAX's
    unfused one: unfused, with the pair grid through K2's plain version
    (use_fused_mm), and the whole-match path through K3's, K4's and K5's
    plain versions (use_fused_match); 1e-9 relative."""
    jloop, tloop = _dp_loops(MomentMatchingPILCO, JaxMomentMatchingPILCO)
    jdrift, jpol = _dp_state()
    want = float(jloop.policy_loss_fn(jpol, jax.random.PRNGKey(0), drift=jdrift))
    tdrift, tpol = _torch_models(jdrift, jpol)
    tloop.use_fused_mm = route == "pair"
    tloop.use_fused_match = route == "whole"
    got = tloop.policy_loss_fn(tpol, None, drift=tdrift)
    assert abs(float(got.detach()) - want) <= 1e-9 * abs(want), (float(got.detach()), want)


# ---------------------------------------------------------------- loop iterations
def _check_iteration(loop, state_dim, action_dim, scale):
    loop.step()  # random-action first episode
    num_steps = loop.episode_spec.num_steps
    assert loop.episodes[0].states.shape == (num_steps + 1, state_dim)
    assert loop.episodes[0].actions.shape == (num_steps, action_dim)
    assert np.all(np.abs(loop.episodes[0].actions) <= scale)
    assert np.isfinite(loop.update_dynamics()["loss"])
    assert np.isfinite(loop.update_policy()["loss"])
    ep = loop.step()
    assert len(loop.episodes) == 2
    for k in ("rewards", "eReward", "vReward"):
        assert k in ep.metrics and np.isfinite(ep.metrics[k]), (k, ep.metrics)
    assert "vSuccess" in ep.metrics


@pytest.mark.parametrize("cls", [MomentMatchingPILCO, PathwisePILCO])
def test_torch_mountain_car_iteration_runs(cls):
    """The mountain-car task (no encoder, 2-D state, 1-D force) through a
    fit-policy-collect iteration, as tests/test_loops.py runs JAX's."""
    loop = load_example("mountain_car").build_loop(
        5, CPU, torch.float64,
        drift_spec=DriftSpec(num_centers=6, max_iters=10, pad_data_multiple=0),
        policy_spec=PolicySpec(num_centers=5, step_limit=10, batch_size=8, num_bases=16,
                               num_restarts=2, action_scale=4.0),
        loop_cls=cls, validation_samples=2,
    )
    _check_iteration(loop, 2, 1, 4.0)


@pytest.mark.parametrize("cls", [MomentMatchingPILCO, PathwisePILCO])
def test_torch_double_pendulum_lck_iteration_runs(cls):
    """The double pendulum with an LCK drift and a 2-D-torque LCK policy
    through a fit-policy-collect iteration, as tests/test_loops.py runs
    JAX's: W is (4, 4) on the drift and (2, 2) on the policy."""
    loop = load_example("double_pendulum").build_loop(
        7, CPU, torch.float64,
        drift_spec=DriftSpec(num_centers=8, max_iters=10, pad_data_multiple=0, coregionalize=True),
        policy_spec=PolicySpec(num_centers=5, step_limit=10, batch_size=8, num_bases=16,
                               num_restarts=2, action_scale=2.0, coregionalize=True),
        horizon=0.6, loop_cls=cls, validation_samples=2,
    )
    loop.step()
    loop.episodes.pop()  # _check_iteration takes the first episode itself
    _check_iteration(loop, 4, 2, 2.0)
    assert loop.drift_model.w.shape == (4, 4) and loop.policy_model.w.shape == (2, 2)


@pytest.mark.parametrize("task", ["double_pendulum", "mountain_car"])
def test_torch_runner_full_run_specs(task):
    """The runners' defaults are the JAX runners' full runs: the specs the
    flags give without options, and what --smoke and the overrides change."""
    run = load_example(task)
    args = run.parser().parse_args([])
    drift, policy, episodes, validation = run.run_specs(args)
    assert args.device == "cuda"
    if task == "double_pendulum":
        assert (args.variant, args.dt, args.horizon, episodes, validation) == ("pathwise", 0.05, 2.5, 15, 100)
        want = (JaxDriftSpec(num_centers=320, max_iters=1600, coregionalize=True, per_output_noise=True),
                JaxPolicySpec(num_centers=100, step_limit=3000, action_scale=2.0, coregionalize=True))
    else:
        assert (args.variant, args.dt, args.horizon, episodes, validation) == ("mm", 0.1, 5.0, 8, 30)
        want = (JaxDriftSpec(num_centers=128, max_iters=600),
                JaxPolicySpec(num_centers=20, step_limit=3000, action_scale=4.0))
    for got, jax_spec in zip((drift, policy), want):
        for field in dataclasses.fields(got):
            if hasattr(jax_spec, field.name) and field.name not in ("loss_dtype", "mm_unroll"):
                assert getattr(got, field.name) == getattr(jax_spec, field.name), field.name
    args = run.parser().parse_args(["--smoke", "--step-limit", "7", "--drift-optimizer", "natgrad_adam",
                                    "--mm-loss-f64", "--validation-samples", "0", "--no-per-output-noise"])
    drift, policy, episodes, validation = run.run_specs(args)
    assert policy.step_limit == 7 and policy.loss_dtype == torch.float64 and validation == 0
    assert drift.optimizer == "natgrad_adam" and not drift.per_output_noise and episodes <= 3


def test_torch_render_writes_files(tmp_path):
    pytest.importorskip("matplotlib")
    from gpflowpilco_torch.envs.render import render_frame, render_gif, render_trajectory

    gen = torch.Generator().manual_seed(0)
    for env in (CartPole(), MountainCar(), DoublePendulum()):
        x0 = torch.zeros(env.state_dim, dtype=torch.float64)
        states, _ = tbase.rollout(
            env, lambda s: env.action_space.sample(gen, dtype=s.dtype), x0, 0.1, 5)
        name = type(env).__name__
        strip = render_trajectory(env, states, tmp_path / f"{name}.png", num_frames=3)
        gif = render_gif(env, states.numpy(), tmp_path / f"{name}.gif", stride=2)
        assert pathlib.Path(strip).stat().st_size > 0 and pathlib.Path(gif).stat().st_size > 0
        assert render_frame(env, states[-1]) is not None


def test_torch_dp_rollout_plan():
    """K6's forward at the double pendulum's widths (Ld=4 drift latents over
    DXU = 6 + 2 = 8 inputs, B=1024, M=320): float32 keeps the member's tables
    resident in shared memory, 193,536 bytes plus the 35,840-byte exchange
    and stream area, 3,072 bytes under the cap; float64 streams them (the
    ring); from M=344 on, the float32 tables no longer fit either."""
    from gpflowpilco_torch.ops import rollout_cuda as rc

    meta = rc.RolloutMeta(num_steps=50, dt=1.0, squash_scale=3.99999, active_dims=(0, 1), state_dim=4,
                          enc_dim=6, act_dim=2, num_latent=4, pol_latent=2)
    assert rc.fwd_plan(meta, 1024, 320, torch.float32) == ("resident", 229376)
    assert rc.FWD_SMEM_MAX - 229376 == 3072
    assert rc.fwd_plan(meta, 1024, 320, torch.float64)[0] == "ring"
    assert rc.fwd_plan(meta, 1024, 340, torch.float32)[0] == "resident"
    assert rc.fwd_plan(meta, 1024, 344, torch.float32)[0] == "ring"
