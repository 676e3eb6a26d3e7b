"""The PyTorch port's policy loop against the JAX package (float64): the
multistart Adam driver and the multistart ``update_policy``, validation
rollouts and the cartpole success mask, the optimism noise floor and
per-output noise, checkpoints and the loop hooks."""
import dataclasses
import pathlib
import pickle
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.loops.core import EpisodeData as JaxEpisodeData
from gpflowpilco_tpu.loops.pilco import DriftSpec as JaxDriftSpec
from gpflowpilco_tpu.loops.pilco import MomentMatchingPILCO as JaxMomentMatchingPILCO
from gpflowpilco_tpu.loops.pilco import PathwisePILCO as JaxPathwisePILCO
from gpflowpilco_tpu.loops.pilco import PolicySpec as JaxPolicySpec
from gpflowpilco_tpu.models import builders as jbuilders
from gpflowpilco_tpu.utils import optimizers as jopt
from gpflowpilco_torch.convert import gpr_from_numpy, svgp_from_numpy
from gpflowpilco_torch.envs.base import rollout as env_rollout
from gpflowpilco_torch.loops.driver import outer_loop
from gpflowpilco_torch.loops.metrics import make_validation_metrics, validation_rollouts
from gpflowpilco_torch.loops.pilco import DriftSpec, MomentMatchingPILCO, PathwisePILCO, PolicySpec
from gpflowpilco_torch.models.builders import build_svgp, policy_mask
from gpflowpilco_torch.utils import optimizers as topt

from ._torch_export import CPU, gpr_to_numpy, jax_gpr, jax_svgp, svgp_to_numpy, t

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
import experiment as jax_experiment  # noqa: E402
import metrics_torch  # noqa: E402
import run_torch  # noqa: E402

torch.set_num_threads(1)


def _tiny_loop(loop_cls=PathwisePILCO, seed=5, directory=None, validation_samples=2, **policy):
    """The tiny loop of tests/test_loops.py (8-step horizon, 2 validation
    rollouts, K=2 multistart), in float64."""
    return run_torch.build_loop(
        seed, CPU, torch.float64,
        drift_spec=DriftSpec(num_centers=6, max_iters=10, pad_data_multiple=0),
        policy_spec=PolicySpec(
            **{**dict(num_centers=5, step_limit=10, batch_size=8, num_bases=16, num_restarts=2), **policy}
        ),
        horizon=0.8,  # 8 steps
        loop_cls=loop_cls,
        directory=directory,
        validation_samples=validation_samples,
    )


def _iterate(loop):
    loop.update_dynamics()
    loop.update_policy()
    return loop.step()


# ----------------------------------------------------------------------------- multistart driver
def test_torch_multistart_matches_jax_at_exported_candidates():
    """K=2 candidates (a policy and a fresh numpy q_mu) through 20 steps of
    JAX's adam_minimize_multistart and the port's, both on the deterministic
    5-step MM loss at the same exported drift: the best losses, the traces
    and the winner's q_mu agree to 1e-8 relative, and so does the winner."""
    horizon = 0.5
    env, encoder, objective, spec = jax_experiment.build_task(jnp.float64, horizon=horizon)
    jloop = JaxMomentMatchingPILCO(
        env, spec, objective, encoder, dtype=jnp.float64,
        policy_spec=JaxPolicySpec(num_restarts=2, mm_unroll=1),
    )
    jdrift = jax_svgp(10, num_latent=4, m=8, d=6)
    jdrift = dataclasses.replace(jdrift, q_mu=0.2 * jdrift.q_mu)
    jpol = jax_svgp(20, num_latent=1, m=6, d=5)
    q_fresh = 1e-3 * np.random.default_rng(7).normal(size=jpol.q_mu.shape)
    cands = [jpol, dataclasses.replace(jpol, q_mu=jnp.asarray(q_fresh))]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *cands)
    sched = jopt.make_policy_schedule(20, 0.05)
    want_bests, want_best, want_traces, _ = jopt.adam_minimize_multistart(
        lambda m, k, d: jloop.policy_loss_fn(m, k, drift=d),
        stacked, jax.random.split(jax.random.PRNGKey(0), 2), num_steps=20, schedule=sched,
        global_clipnorm=1.0, mask=jbuilders.policy_mask(stacked), loss_args=(jdrift,),
    )
    want_best, want_traces = np.asarray(want_best), np.asarray(want_traces)

    tloop = run_torch.build_loop(0, CPU, torch.float64, horizon=horizon, loop_cls=MomentMatchingPILCO)
    tdrift = svgp_from_numpy(svgp_to_numpy(jdrift), CPU, torch.float64).requires_grad_(False)
    tcands = [svgp_from_numpy(svgp_to_numpy(c), CPU, torch.float64) for c in cands]
    bests, best, traces, skipped = topt.adam_minimize_multistart(
        [lambda c=c: tloop.policy_loss_fn(c, None, drift=tdrift) for c in tcands],
        [policy_mask(c) for c in tcands], num_steps=20,
        schedule=topt.make_policy_schedule(20, 0.05), global_clipnorm=1.0,
    )
    assert skipped == 0 and traces.shape == (2, 20) and best.shape == (2,)
    np.testing.assert_allclose(best, want_best, rtol=1e-8)
    np.testing.assert_allclose(traces, want_traces, rtol=1e-8)
    win = int(np.argmin(want_best))
    assert int(np.argmin(best)) == win
    names = [n for n, p in tcands[win].named_parameters() if p.requires_grad]
    q_mu = bests[win][names.index("q_mu")]
    np.testing.assert_allclose(q_mu.numpy(), np.asarray(want_bests.q_mu[win]), rtol=1e-8)


def test_torch_multistart_returns_best_seen_not_final():
    """The twin of tests/test_training.py's best-seen test: a late learning
    rate explosion throws the iterate away from the optimum, and the optimizer
    returns the best-seen parameters and loss, not the final step's."""
    xs = [t([0.0]).requires_grad_(True), t([3.0]).requires_grad_(True)]
    schedule = lambda count: 0.05 if count < 60 else 100.0  # noqa: E731
    bests, best, traces, _ = topt.adam_minimize_multistart(
        [lambda x=x: torch.sum((x - 1.0) ** 2) for x in xs], [[x] for x in xs],
        num_steps=100, schedule=schedule, global_clipnorm=None,
    )
    assert traces[:, -1].min() > 1e2 * best.max()
    np.testing.assert_allclose(best, traces.min(axis=1), rtol=1e-12)
    np.testing.assert_allclose(torch.cat([b[0] for b in bests]).numpy(), 1.0, atol=0.2)


def _noisy_quadratic(x, gen, poison_at=None):
    """A loss with a large gradient (so the clip acts), drawing noise from
    ``gen`` every call, non-finite at one call."""
    calls = []

    def loss():
        calls.append(1)
        val = torch.sum((x - 2.0) ** 4) + 1e-3 * torch.randn((), generator=gen, dtype=x.dtype)
        if poison_at is not None and len(calls) == poison_at:
            val = val * float("nan")
        return val

    return loss


@pytest.mark.parametrize("i", [0, 1, 2])
def test_torch_multistart_candidates_are_independent(i):
    """Candidate i of a K=3 run equals a K=1 run of candidate i with the
    same generator, bit for bit (the port's stand-in for the JAX runner's
    chunking invariance); candidate 1's poisoned gradient skips one of its
    own steps only."""
    starts = [[0.1, -0.5], [3.0, 1.0], [-2.0, 0.3]]
    sched = topt.make_policy_schedule(25, 0.05)

    def run(idx):
        xs = [t(starts[j]).requires_grad_(True) for j in idx]
        fns = [_noisy_quadratic(x, torch.Generator().manual_seed(10 + j), poison_at=5 if j == 1 else None)
               for x, j in zip(xs, idx)]
        return topt.adam_minimize_multistart(fns, [[x] for x in xs], num_steps=25, schedule=sched)

    bests, best, traces, skipped = run([0, 1, 2])
    one_bests, one_best, one_traces, one_skipped = run([i])
    assert skipped == 1 and one_skipped == (1 if i == 1 else 0)
    assert np.isnan(traces[1, 4])
    np.testing.assert_array_equal(traces[i], one_traces[0])
    np.testing.assert_array_equal(best[i], one_best[0])
    assert torch.equal(bests[i][0], one_bests[0][0])
    assert len({float(b) for b in best}) == 3


@pytest.mark.parametrize("loop_cls", [PathwisePILCO, MomentMatchingPILCO])
def test_torch_update_policy_multistart_keeps_the_snapshot(loop_cls):
    """update_policy at K=3 with retain_best_policy: the info keys, the
    winner is the argmin of the best-seen losses and its loss the minimum of
    its trace, and the best-validated snapshot (candidate 1, trained as a
    copy) is unchanged, tensor for tensor."""
    loop = _tiny_loop(loop_cls, num_restarts=3, step_limit=6)
    loop.step()
    _iterate(loop)
    snapshot = loop.best_policy_model
    assert snapshot is not None and snapshot is not loop.policy_model
    before = {n: p.detach().clone() for n, p in snapshot.named_parameters()}
    loop.update_dynamics()
    info = loop.update_policy()
    assert {"loss", "losses", "nan_frac", "skipped_steps", "best_restart", "restart_losses"} <= set(info)
    assert len(info["restart_losses"]) == 3 and info["losses"].shape == (6,)
    assert info["best_restart"] == int(np.argmin(info["restart_losses"]))
    assert info["loss"] == info["restart_losses"][info["best_restart"]] == np.nanmin(info["losses"])
    assert loop.best_policy_model is snapshot and loop.policy_model is not snapshot
    assert all(torch.equal(p, before[n]) for n, p in snapshot.named_parameters())
    loop.step()


# ----------------------------------------------------------------------------- validation
def _x0_batch(spec, n, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(spec.state_mean) + rng.normal(size=(n, 4)) @ np.asarray(spec.state_scale_tril).T


def test_torch_validation_rollouts_match_jax():
    """validation_rollouts at exported x0 and an exported policy against
    the JAX package's vmapped validation rollout: the rewards to 1e-10
    relative over the full 30-step horizon, and the success flags equal."""
    env, encoder, objective, spec = jax_experiment.build_task(jnp.float64)
    jloop = JaxPathwisePILCO(env, spec, objective, encoder, dtype=jnp.float64,
                             metrics={"v": jax_experiment.make_validation_metrics(3)})
    jpol = jax_svgp(21, num_latent=1, m=6, d=5)
    jpol = dataclasses.replace(jpol, q_mu=3.0 * jpol.q_mu)
    jloop.policy_model = jpol
    jloop.metrics["v"](jloop, None, None)  # builds the loop's jitted validation program
    x0 = _x0_batch(spec, 6, 3)
    want_rewards, want_succ = jloop._jit_validation(jpol, jnp.asarray(x0))

    tloop = run_torch.build_loop(0, CPU, torch.float64)
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float64)
    rewards, states = validation_rollouts(tloop, tpol, t(x0))
    assert rewards.shape == (6,) and states.shape == (6, 31, 4)
    np.testing.assert_allclose(rewards.numpy(), np.asarray(want_rewards), rtol=1e-10)
    np.testing.assert_array_equal(metrics_torch.success_mask(tloop.env, states).numpy(), np.asarray(want_succ))


def test_torch_validation_batched_matches_serial_rollouts():
    """The batched validation rollout equals serial envs/base.rollout calls
    from each x0 to 1e-12 (float64), states and rewards, and the metric
    returns the mean reward and a success share in [0, 1]."""
    loop = run_torch.build_loop(0, CPU, torch.float64)
    pol = svgp_from_numpy(svgp_to_numpy(jax_svgp(22, num_latent=1, m=6, d=5)), CPU, torch.float64)
    spec = loop.episode_spec
    x0 = t(_x0_batch(spec, 5, 4))
    rewards, states = validation_rollouts(loop, pol, x0)
    for i in range(5):
        with torch.no_grad():
            serial, _ = env_rollout(loop.env, loop.policy_fn(pol), x0[i], spec.step_size, spec.num_steps)
            reward = -torch.sum(loop.objective(loop.encode(serial)))
        torch.testing.assert_close(states[i], serial, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(rewards[i], reward, rtol=1e-12, atol=0.0)
    loop.policy_model = pol
    out = make_validation_metrics(lambda lp, st: metrics_torch.success_mask(lp.env, st), 7)(loop, None, None)
    assert set(out) == {"vReward", "vSuccess"} and np.isfinite(out["vReward"]) and 0 <= out["vSuccess"] <= 1


def test_torch_success_mask_matches_jax():
    """The cartpole success mask against experiment.py's on exported
    trajectories: upright runs of exactly 9 and 10 steps, at the start and
    at the end, two runs of 9 with one step between, and random ones."""
    tip_up, down = np.zeros(4), np.array([0.0, np.pi, 0.0, 0.0])

    def runs(*spans):
        traj = np.tile(down, (31, 1))
        for a, b in spans:
            traj[a:b] = tip_up
        return traj

    rng = np.random.default_rng(0)
    trajs = [runs((3, 12)), runs((3, 13)), runs((0, 10)), runs((21, 31)), runs((22, 31)),
             runs((2, 11), (12, 21)), runs(), runs((0, 31))]
    trajs += [np.concatenate([rng.normal(0, 0.05, (31, 1)), rng.normal(0, 0.12, (31, 1)),
                              rng.normal(size=(31, 2))], axis=1) for _ in range(6)]
    trajs = np.stack(trajs)
    env = jax_experiment.CartPole()
    want = np.array([bool(jax_experiment.success_mask(env, jnp.asarray(tr))) for tr in trajs])
    got = metrics_torch.success_mask(run_torch.CartPole(), t(trajs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[:8].tolist() == [False, True, True, True, False, False, False, True]
    assert 0 < want[8:].sum() < 6  # the random ones go both ways


def test_torch_acting_gate_reads_vreward():
    """The snapshot's score is the validation reward when validation runs,
    not the training episode's reward."""
    loop = _tiny_loop(validation_samples=0)
    loop.metrics["validation"] = lambda lp, s, a: {"vReward": 123.0 if lp.policy_model is not None else np.nan}
    loop.step()
    assert loop.best_policy_score == float("-inf")
    ep = _iterate(loop)
    assert ep.metrics["vReward"] == 123.0 != ep.metrics["rewards"]
    assert loop.best_policy_score == 123.0


# ----------------------------------------------------------------------------- noise
def _episodes_both(loop, n=2):
    """n random episodes of the torch loop, the last one forged optimistic,
    and the same episodes for the JAX package's loop."""
    for _ in range(n):
        loop.step()
    last = loop.episodes[-1]
    m = {**last.metrics, "eReward": float(last.metrics["rewards"]) + 50.0}
    loop.episodes[-1] = last._replace(metrics=m)
    return [JaxEpisodeData(states=e.states, actions=e.actions, metrics=dict(e.metrics)) for e in loop.episodes]


@pytest.mark.parametrize("kind", ["svgp", "gpr"])
def test_torch_optimism_noise_floor_matches_jax(kind):
    """_optimism_noise_floor on an exported incumbent (an SVGP or a GPR on
    the loop's 6 inputs and 4 outputs) and the same episodes equals the JAX
    package's to 1e-12 relative."""
    tloop = _tiny_loop()
    tloop.drift_spec = DriftSpec(optimism_tolerance=1.0, optimism_noise_mult=2.0)
    jloop = jax_experiment.build_loop(
        JaxPathwisePILCO, None, seed=5, drift_spec=JaxDriftSpec(optimism_tolerance=1.0, optimism_noise_mult=2.0),
        horizon=0.8, validation_samples=2,
    )
    jloop.episodes = _episodes_both(tloop)
    if kind == "svgp":
        jm = jax_svgp(30, num_latent=4, m=8, d=6)
        tm = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)
    else:
        jm = jax_gpr(31, n=16, d=6, p=4)
        tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64)
    want = np.asarray(jloop._optimism_noise_floor(jm))
    got = tloop._optimism_noise_floor(tm)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("per_output", [False, True])
def test_torch_apply_noise_floor_matches_jax(per_output):
    """_apply_noise_floor for a scalar noise (the floor's mean) and a (P,)
    one (each output's floor) equals the JAX package's raw noise to 1e-12."""
    jm = jax_svgp(32, num_latent=4, m=8, d=6)
    if per_output:
        jm = dataclasses.replace(jm, raw_noise=jnp.asarray([-3.0, -1.0, -6.0, 0.5]))
    floor = np.array([0.01, 0.5, 1e-4, 0.2])
    want = JaxPathwisePILCO._apply_noise_floor(jm, jnp.asarray(floor))
    tm = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)
    got = PathwisePILCO._apply_noise_floor(tm, t(floor))
    assert got is tm and tm.raw_noise.shape == ((4,) if per_output else ())
    np.testing.assert_allclose(tm.raw_noise.detach().numpy(), np.asarray(want.raw_noise), rtol=1e-12)


def test_torch_per_output_noise_matches_jax_builder():
    """build_svgp(per_output_noise=True): a (P,) noise, noise_variance x
    each output's variance, equal to the JAX builder's to 1e-12."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 6))
    y = rng.normal(size=(40, 4)) * np.array([1e-3, 0.1, 1.0, 10.0])
    want = jbuilders.build_svgp(x, y, num_inducing=8, key=jax.random.PRNGKey(0), noise_variance=0.3,
                                per_output_noise=True, dtype=jnp.float64)
    got = build_svgp(t(x), t(y), num_inducing=8, generator=torch.Generator().manual_seed(0),
                     noise_variance=0.3, per_output_noise=True)
    assert got.noise_variance.shape == (4,)
    np.testing.assert_allclose(got.noise_variance.detach().numpy(), np.asarray(want.noise_variance),
                               rtol=1e-12)
    plain = build_svgp(t(x), t(y), num_inducing=8, generator=torch.Generator().manual_seed(0))
    assert plain.noise_variance.shape == ()


def test_torch_pessimistic_refit_noise_floor():
    """The twin of tests/test_loops.py's pessimistic-refit test, with
    per-output noise on: inert without metrics, the refit's noise floored at
    the incumbent's held-out MSE after an optimistic episode, inert again
    after a realistic one."""
    loop = _tiny_loop(MomentMatchingPILCO, seed=31)
    loop.drift_spec = dataclasses.replace(
        loop.drift_spec, optimism_tolerance=1.0, optimism_noise_mult=2.0, per_output_noise=True
    )
    loop.step()
    info0 = loop.update_dynamics()
    assert "pessimistic" not in info0
    loop.update_policy()
    loop.step()

    m = dict(loop.episodes[-1].metrics)
    m["eReward"] = float(m["rewards"]) + 50.0
    loop.episodes[-1] = loop.episodes[-1]._replace(metrics=m)
    floor = loop._optimism_noise_floor(loop.drift_model)
    assert floor is not None and bool(torch.all(floor > 0))
    info = loop.update_dynamics()
    assert info.get("pessimistic") is True
    noise = loop.drift_model.noise_variance.detach()
    assert noise.shape == (4,) and bool(torch.all(noise >= floor * (1 - 1e-12)))

    m2 = dict(loop.episodes[-1].metrics)
    m2["eReward"] = float(m2["rewards"])
    loop.episodes[-1] = loop.episodes[-1]._replace(metrics=m2)
    assert loop._optimism_noise_floor(loop.drift_model) is None


# ----------------------------------------------------------------------------- checkpoints
def test_torch_checkpoint_roundtrip_and_deterministic_resume():
    """The twin of tests/test_loops.py's resume test: three episodes
    straight through equal two, a checkpoint, a restore into a fresh loop
    and a third."""
    with tempfile.TemporaryDirectory() as tmp:
        a = _tiny_loop(MomentMatchingPILCO, seed=9)
        a.step()
        _iterate(a)
        _iterate(a)

        b = _tiny_loop(MomentMatchingPILCO, seed=9, directory=tmp)
        b.step()
        _iterate(b)
        b.save()

        c = _tiny_loop(MomentMatchingPILCO, seed=9, directory=tmp)
        assert len(c.episodes) == 2
        np.testing.assert_array_equal(c.episodes[1].states, b.episodes[1].states)
        assert torch.equal(c.policy_model.q_mu, b.policy_model.q_mu)
        assert torch.equal(c.drift_model.q_mu, b.drift_model.q_mu)
        assert c.best_policy_score == b.best_policy_score
        _iterate(c)
        np.testing.assert_allclose(c.episodes[2].states, a.episodes[2].states, rtol=1e-12, atol=1e-12)


def test_torch_checkpoint_manager_semantics():
    """The twin of tests/test_loops.py's checkpoint-manager test: numbered
    files, the newest 3 kept, no .tmp left, a truncated newest file skipped
    for the one before it, a newer schema refused; and outer_loop(save=True)
    checkpoints every episode, an ensemble drift included."""
    with tempfile.TemporaryDirectory() as tmp:
        a = _tiny_loop(MomentMatchingPILCO, seed=9, directory=tmp)
        for _ in range(2):
            a.step()
            a.save()
        _iterate(a)
        a.save()
        a.step()
        a.save()
        files = sorted(pathlib.Path(tmp).glob("ckpt-*.pkl"))
        assert [f.name for f in files] == ["ckpt-2.pkl", "ckpt-3.pkl", "ckpt-4.pkl"]
        assert not list(pathlib.Path(tmp).glob("*.tmp"))

        latest = pathlib.Path(tmp) / "ckpt-4.pkl"
        data = latest.read_bytes()
        latest.write_bytes(data[: len(data) // 2])
        b = _tiny_loop(MomentMatchingPILCO, seed=9, directory=tmp)
        assert len(b.episodes) == 3
        np.testing.assert_array_equal(b.episodes[2].states, a.episodes[2].states)

        with (pathlib.Path(tmp) / "ckpt-9.pkl").open("wb") as f:
            pickle.dump({"schema": 99, "episodes": []}, f)
        with pytest.raises(ValueError, match="schema"):
            _tiny_loop(MomentMatchingPILCO, seed=9, directory=tmp)

    with tempfile.TemporaryDirectory() as tmp:
        loop = _tiny_loop(seed=4, directory=tmp)
        loop.drift_spec = DriftSpec(model_type="gpr", optimizer="hmc", max_iters=5, hmc_chains=2,
                                    hmc_warmup=4, hmc_samples=4, hmc_leapfrog=2, hmc_ensemble=2)
        outer_loop(loop, num_episodes=2, log_summaries=False)
        assert sorted(p.name for p in pathlib.Path(tmp).glob("*.pkl")) == ["ckpt-1.pkl", "ckpt-2.pkl"]
        back = _tiny_loop(seed=4, directory=tmp)
        assert type(back.drift_model).__name__ == "GPREnsemble"
        assert torch.equal(back.drift_model.members.raw_noise, loop.drift_model.members.raw_noise)


def test_torch_loop_callbacks_fire():
    """The twin of tests/test_loops.py's hook test: unroll hooks get (loop,
    states, actions) before the metrics, step hooks (loop, episode) after
    the episode is appended."""
    loop = _tiny_loop(MomentMatchingPILCO, seed=23)
    seen = {"step": [], "unroll": []}
    loop.step_callbacks.append(lambda lp, ep: seen["step"].append((lp, ep, len(lp.episodes))))
    loop.unroll_callbacks.append(
        lambda lp, states, actions: seen["unroll"].append((states.shape, actions.shape, len(lp.episodes)))
    )
    ep = loop.step()
    assert len(seen["step"]) == 1 and len(seen["unroll"]) == 1
    assert seen["step"][0][0] is loop and seen["step"][0][1] is ep and seen["step"][0][2] == 1
    n = loop.episode_spec.num_steps
    assert seen["unroll"][0] == ((n + 1, 4), (n, 1), 0)
