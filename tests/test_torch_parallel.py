"""The port's scale-out (gpflowpilco_torch/parallel/) on gloo process groups
on the CPU, in float64.

The single-rank sharded loss of every route equals the JAX package's
``make_pathwise_train_step`` loss_fn on the same paths and x0 (the JAX
side runs here, in the parent; the ranks import torch only, through
tests/_torch_parallel_worker.py). Then each mesh shape is one spawn whose
ranks run all of that shape's checks, held against the single-rank run:
routes (a)-(d) at dp x tp in {2 x 1, 1 x 2, 2 x 2} where the route allows
it, a train step, the three ValueErrors, sharded HMC and the sharded
resampler. On the CPU the kernel routes run the kernels' plain versions."""
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpflowpilco_tpu.loops.core import EpisodeSpec
from gpflowpilco_tpu.models.gp import GPREnsemble
from gpflowpilco_tpu.models.pathwise import generate_paths_gpr, generate_paths_svgp
from gpflowpilco_tpu.moment_matching.gp import SVGPTransform
from gpflowpilco_tpu.moment_matching.rules import Probit, Scale, Shift
from gpflowpilco_tpu.moments import Chain
from gpflowpilco_tpu.parallel.mesh import make_mesh
from gpflowpilco_tpu.parallel.pathwise import make_pathwise_train_step
from gpflowpilco_tpu.parallel.resample import systematic_resample_indices

from . import _torch_parallel_worker as worker
from ._torch_export import gpr_to_numpy, jax_gpr_members, paths_to_numpy, svgp_to_numpy

torch.set_num_threads(1)

SPEC = EpisodeSpec(state_mean=np.asarray([0.0, math.pi, 0.0, 0.0]), state_scale_tril=0.1 * np.eye(4),
                   horizon=0.5, step_size=0.1)
MEMBERS = 2
TRAINABLE = ("kernel.raw_lengthscales", "z", "q_mu")  # the rollout op's (policy_mask)


def _chain_fn(p):
    return Chain(Scale(scale=jnp.asarray(20.0 - 1e-5)), Shift(shift=jnp.asarray(-0.5)), Probit(),
                 SVGPTransform(model=p, deterministic=True))


def _jax_models():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _build_models

    encoder, drift, policy, objective = _build_models(jnp.float64, m_drift=16, m_policy=8)
    members = jax_gpr_members(21, k=MEMBERS, n=20, d=6, p=4)
    return encoder, drift, GPREnsemble(members=members, num_members=MEMBERS), policy, objective


def _jax_loss_fn(drift, encoder, objective):
    _, loss_fn = make_pathwise_train_step(
        make_mesh(dp=1, tp=1), drift, _chain_fn, encoder, objective, SPEC,
        batch_size=worker.BATCH, num_bases=worker.BASES, optimizer=optax.adam(1e-2), dtype=jnp.float64)
    return loss_fn


def _draws(key, drift, ensemble):
    """The paths and x0 JAX's loss_fn draws from ``key`` (its key splits,
    parallel/pathwise.py:140-143 and :212-218), as numpy."""
    mean0, tril0 = jnp.asarray(SPEC.state_mean), jnp.asarray(SPEC.state_scale_tril)
    k_paths, k_init = jax.random.split(key)
    paths = generate_paths_svgp(drift, k_paths, worker.BATCH, worker.BASES)
    x0 = mean0 + jax.random.normal(k_init, (worker.BATCH, 4), jnp.float64) @ tril0.T
    s_per = worker.BATCH // MEMBERS
    keys = jax.random.split(k_paths, MEMBERS)
    epaths = jax.vmap(lambda m, kk: generate_paths_gpr(m, kk, s_per, worker.BASES))(ensemble.members, keys)
    ex0 = mean0 + jax.random.normal(k_init, (MEMBERS, s_per, 4), jnp.float64) @ tril0.T
    return paths_to_numpy(paths), paths_to_numpy(epaths), np.asarray(x0), np.asarray(ex0).reshape(-1, 4)


@pytest.fixture(scope="module")
def setup():
    """The payload every rank gets, the JAX losses and gradients at its
    paths and x0, and the port's single-rank results."""
    encoder, drift, ensemble, policy, objective = _jax_models()
    key = jax.random.PRNGKey(3)
    paths, epaths, x0, ex0 = _draws(key, drift, ensemble)
    rng = np.random.default_rng(5)
    payload = dict(
        policy=svgp_to_numpy(policy), drift=svgp_to_numpy(drift), ensemble=gpr_to_numpy(ensemble.members),
        paths=paths, ensemble_paths=epaths, x0={"svgp": x0, "ensemble": ex0},
        hmc_init=rng.normal(size=(4, 2)), weights=np.concatenate([np.full(32, 3.0), np.full(32, 1.0)]),
        u0=float(jax.random.uniform(jax.random.PRNGKey(9), (), jnp.float64, minval=0.0, maxval=1.0 / 64)),
    )
    jax_out = {}
    for kind, model in (("svgp", drift), ("ensemble", ensemble)):
        loss_fn = _jax_loss_fn(model, encoder, objective)
        jax_out[kind] = jax.jit(jax.value_and_grad(loss_fn))(policy, key)
    single = worker.single_process(worker.pathwise_checks, dict(
        payload, mesh=(1, 1), routes=tuple(worker.ROUTES), hmc=True, resample=True))
    single["hmc"] = worker.hmc_check(None, payload)
    single["resample"] = worker.resample_check(None, payload)
    return payload, jax_out, single


def _jax_grad(grads, names):
    def leaf(name):
        obj = grads
        for part in name.split("."):
            obj = getattr(obj, part)
        return np.asarray(obj).ravel()

    return np.concatenate([leaf(n) for n in names])


def _cos_ratio(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b)), np.linalg.norm(a) / np.linalg.norm(b)


@pytest.mark.parametrize("route", tuple(worker.ROUTES))
def test_torch_parallel_single_rank_matches_jax(setup, route):
    """At one rank, each route's loss equals JAX's loss_fn on the same paths
    and x0 to 1e-10 relative, and its gradient (the trainable leaves under
    the rollout op, every leaf otherwise) at cosine and norm ratio within
    1e-10 of 1. JAX's plain route is the reference of all: the kernel
    routes compute the same function (their plain versions here)."""
    _, jax_out, single = setup
    res = single[route]
    kind = worker.ROUTES[route][0]
    want_loss, want_grads = jax_out[kind]
    assert abs(res["loss"] - float(want_loss)) <= 1e-10 * abs(float(want_loss))
    names = TRAINABLE if worker.ROUTES[route][2] else tuple(res["names"])
    got = _grad_of(res, names)
    cos, ratio = _cos_ratio(got, _jax_grad(want_grads, names))
    assert cos >= 1.0 - 1e-10 and abs(ratio - 1.0) <= 1e-10, (cos, ratio)


def _grad_of(res, names):
    sizes = dict(zip(res["names"], res["sizes"]))
    parts = dict(zip(res["names"], torch.split(res["grad"], [sizes[n] for n in res["names"]])))
    return np.concatenate([parts[n].numpy() for n in names])


def _hold_ranks(results, single, routes):
    """Every rank's loss and dp-summed gradient against the single-rank
    run: loss to 1e-12 relative, gradient at cosine >= 1 - 1e-12 and norm
    ratio within 1e-10 of 1; the train step's parameters equal on every
    rank, moved, and within 1e-9 of the single-rank step's change."""
    for route in routes:
        want = single[route]
        for rank, res in enumerate(results):
            r = res[route]
            assert abs(r["loss"] - want["loss"]) <= 1e-12 * abs(want["loss"]), (route, rank)
            cos, ratio = _cos_ratio(r["grad"], want["grad"])
            assert cos >= 1.0 - 1e-12 and abs(ratio - 1.0) <= 1e-10, (route, rank, cos, ratio)
            assert torch.equal(r["params"], results[0][route]["params"]), (route, rank)
        step = float((want["params"] - want["start"]).abs().max())
        assert step > 0, route
        assert float((results[0][route]["params"] - want["params"]).abs().max()) <= 1e-9 * step, route


def _spawn(setup, mesh, routes, **extra):
    payload, _, single = setup
    results = worker.spawn(worker.pathwise_checks, mesh[0] * mesh[1],
                           dict(payload, mesh=mesh, routes=routes, **extra))
    return results, single


def test_torch_parallel_dp2(setup):
    """dp=2, tp=1: every route, sharded HMC (4 chains over 2 ranks) equal to
    run_hmc's samples, and the sharded resampler's output slabs equal to
    the local resampler's at a drawn u0 and at JAX's u0."""
    results, single = _spawn(setup, (2, 1), tuple(worker.ROUTES), hmc=True, resample=True)
    _hold_ranks(results, single, tuple(worker.ROUTES))
    assert [tuple(r["coords"]) for r in results] == [(0, 0), (1, 0)]
    hmc = single["hmc"]
    samples = torch.cat([r["hmc"]["samples"] for r in results], dim=1)
    accept = torch.cat([r["hmc"]["accept"] for r in results], dim=1)
    assert float((samples - hmc["samples"]).abs().max()) <= 1e-12 * float(hmc["samples"].abs().max())
    assert float((accept - hmc["accept"]).abs().max()) <= 1e-12
    assert all(abs(r["hmc"]["step_size"] - hmc["step_size"]) <= 1e-12 * hmc["step_size"] for r in results)
    given = torch.cat([r["resample"]["given"] for r in results])
    assert torch.equal(given, single["resample"])
    for r in results:
        assert torch.equal(r["resample"]["drawn"], r["resample"]["local_drawn"])


def test_torch_parallel_tp2(setup):
    """dp=1, tp=2: the plain route with the bases split (the prior's
    partial sum over tp, identity backward for the sum and summed input
    cotangents), the fused SVGP route and the plain ensemble, both
    replicated over tp; fused_rollout refuses tp=2."""
    routes = ("plain", "fused", "ensemble")
    results, single = _spawn(setup, (1, 2), routes)
    _hold_ranks(results, single, routes)
    for r in results:
        assert "tp=1" in r["errors"]["tp"]


def test_torch_parallel_dp2_tp2(setup):
    """dp=2, tp=2 (four ranks): the plain route, the fused route and the
    plain ensemble."""
    routes = ("plain", "fused", "ensemble")
    results, single = _spawn(setup, (2, 2), routes)
    _hold_ranks(results, single, routes)
    assert sorted(tuple(r["coords"]) for r in results) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_torch_parallel_value_errors(setup):
    """The ValueErrors JAX raises, with its hints: an ensemble batch that
    does not divide by members x dp, and the per-step fused drift with an
    ensemble (fused_rollout with tp != 1 is test_torch_parallel_tp2's)."""
    errors = setup[2]["errors"]
    assert errors["tp"] is None
    assert "must divide num_members*dp" in errors["batch"]
    assert "fused_rollout=True" in errors["fused_ensemble"]


def test_torch_parallel_resample_local():
    """The local resampler: degenerate weights send every particle to the
    one weighted ancestor; 3:1 weights give 3/4 of the draws to the first
    half (tests/test_parallel.py's checks); the indices equal JAX's at
    JAX's u0."""
    from gpflowpilco_torch.parallel.resample import systematic_resample
    from gpflowpilco_torch.parallel.resample import systematic_resample_indices as indices

    s = 64
    gen = torch.Generator().manual_seed(9)
    particles = {"x": torch.arange(s, dtype=torch.float64)[:, None]}
    weights = torch.zeros(s, dtype=torch.float64)
    weights[7] = 1.0
    out = systematic_resample(gen, weights, particles)
    assert torch.equal(out["x"], torch.full((s, 1), 7.0, dtype=torch.float64))
    w2 = torch.cat([torch.full((s // 2,), 3.0), torch.full((s // 2,), 1.0)]).double()
    out2 = systematic_resample(gen, w2, particles)
    assert abs(float((out2["x"][:, 0] < s // 2).double().mean()) - 0.75) < 0.05
    key = jax.random.PRNGKey(9)
    want = systematic_resample_indices(key, jnp.asarray(w2.numpy()))
    u0 = jax.random.uniform(key, (), jnp.float64, minval=0.0, maxval=1.0 / s)
    assert np.array_equal(indices(None, w2, u0=torch.tensor(float(u0), dtype=torch.float64)).numpy(),
                          np.asarray(want))
