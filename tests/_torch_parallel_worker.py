"""Ranks of the PyTorch port's scale-out tests: gloo process groups on the
CPU, spawned with torch.multiprocessing. This module imports torch and the
port only, never JAX: the spawn start method imports it anew in every rank.

``spawn`` starts ``world`` ranks of one check function on a free port, each
with its own join deadline, kills them past it, and returns each rank's
result; ``single_process`` runs a check function in this process on a
one-rank process group."""
from __future__ import annotations

import contextlib
import math
import socket
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gpflowpilco_torch.components import GaussianObjective, trigonometric_encoder
from gpflowpilco_torch.convert import gpr_ensemble_from_numpy, paths_from_numpy, svgp_from_numpy
from gpflowpilco_torch.loops.core import EpisodeSpec
from gpflowpilco_torch.models.builders import policy_mask
from gpflowpilco_torch.models.hmc import HMCConfig, run_hmc
from gpflowpilco_torch.moment_matching.gp import SVGPTransform
from gpflowpilco_torch.moment_matching.rules import Probit, Scale, Shift
from gpflowpilco_torch.moments import Chain
from gpflowpilco_torch.parallel.hmc import run_hmc_sharded
from gpflowpilco_torch.parallel.mesh import make_mesh, particle_slab
from gpflowpilco_torch.parallel.pathwise import allreduce_gradients, make_pathwise_train_step
from gpflowpilco_torch.parallel.resample import systematic_resample, systematic_resample_sharded

CPU = torch.device("cpu")
F64 = torch.float64
# the routes of make_pathwise_train_step: (drift, fused, fused_rollout)
ROUTES = {
    "plain": ("svgp", False, False),
    "fused": ("svgp", True, False),
    "fused_rollout": ("svgp", False, True),
    "ensemble": ("ensemble", False, False),
    "ensemble_fused_rollout": ("ensemble", False, True),
}
BATCH, BASES = 16, 64
HMC = HMCConfig(num_warmup=20, num_samples=10, num_leapfrog=4)
HMC_MEAN = (0.5, -1.0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, payload, out_dir):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
        try:
            result = fn(rank, world, payload)
        finally:
            dist.destroy_process_group()
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn(fn, world: int, payload, timeout: float = 120.0):
    """``fn(rank, world, payload)`` on ``world`` gloo ranks; the list of
    their results. Ranks still running after ``timeout`` seconds are
    killed and the call fails."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        port = free_port()
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, payload, out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [(Path(out_dir) / f"rank{r}.err") for r in range(world)]
        text = "\n".join(e.read_text() for e in errors if e.exists())
        if hung or text or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"ranks {hung} hung past {timeout} s; exit codes "
                                 f"{[p.exitcode for p in procs]}\n{text}")
        return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(world)]


@contextlib.contextmanager
def _one_rank_group():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def single_process(fn, payload):
    """``fn(0, 1, payload)`` in this process, on a one-rank gloo group."""
    with _one_rank_group():
        return fn(0, 1, payload)


# ---------------------------------------------------------------------------- the task
def task():
    """The cartpole encoder, cost and initial-state spec of the JAX
    package's scale-out tests (tests/test_parallel.py: horizon 0.5, steps
    of 0.1), in float64."""
    encoder = trigonometric_encoder(active_dims=(1,))
    h = 0.5
    target = encoder(torch.zeros(4, dtype=F64))
    precis = 16.0 * torch.tensor([[h * h, 0, -h, 0, 0], [0, h * h, 0, 0, 0], [-h, 0, 1, 0, 0],
                                  [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]], dtype=F64)
    spec = EpisodeSpec(state_mean=np.asarray([0.0, math.pi, 0.0, 0.0]), state_scale_tril=0.1 * np.eye(4),
                       horizon=0.5, step_size=0.1)
    return encoder, GaussianObjective.create(target=target, precis=precis), spec


def policy_chain(p):
    return Chain(Scale(scale=torch.tensor(20.0 - 1e-5, dtype=F64)), Shift(shift=torch.tensor(-0.5, dtype=F64)),
                 Probit(), SVGPTransform(model=p, deterministic=True))


def flat_grads(policy, names):
    """The gradients of the named parameters in one vector, zeros for a
    parameter without one."""
    params = dict(policy.named_parameters())
    return torch.cat([(params[n].grad if params[n].grad is not None else torch.zeros_like(params[n])).reshape(-1)
                      for n in names]).detach().clone()


def route_loss_and_grad(mesh, payload, route):
    """The route's loss and its dp-summed policy gradient at the payload's
    paths and x0, then one Adam step's parameters, in float64."""
    drift_kind, fused, fused_rollout = ROUTES[route]
    encoder, objective, spec = task()
    policy = svgp_from_numpy(payload["policy"], CPU, F64)
    if drift_kind == "svgp":
        drift = svgp_from_numpy(payload["drift"], CPU, F64).requires_grad_(False)
        paths = paths_from_numpy(payload["paths"], CPU, F64)
    else:
        drift = gpr_ensemble_from_numpy(payload["ensemble"], CPU, F64)
        drift.members.requires_grad_(False)
        paths = paths_from_numpy(payload["ensemble_paths"], CPU, F64)
    x0 = torch.tensor(payload["x0"][drift_kind], dtype=F64)
    if fused_rollout:
        policy_mask(policy)
    opt = torch.optim.Adam(policy.parameters(), lr=1e-2)
    step, loss_fn = make_pathwise_train_step(
        mesh, drift, policy_chain, encoder, objective, spec, batch_size=BATCH, num_bases=BASES,
        optimizer=opt, dtype=F64, fused=fused, fused_rollout=fused_rollout)
    names = [n for n, _ in policy.named_parameters()]
    start = torch.cat([p.detach().reshape(-1) for p in policy.parameters()]).clone()
    loss = loss_fn(policy, paths=paths, x0=x0)
    loss.backward()
    allreduce_gradients(policy.parameters(), mesh.get_group("dp"))
    grad = flat_grads(policy, names)
    step(policy, torch.Generator().manual_seed(11))
    moved = torch.cat([p.detach().reshape(-1) for p in policy.parameters()]).clone()
    return dict(loss=float(loss.detach()), grad=grad, names=names, start=start, params=moved,
                sizes=[p.numel() for p in policy.parameters()])


def pathwise_checks(rank, world, payload):
    """Every route of payload["routes"] on a (dp, tp) mesh, and the three
    ValueErrors where the mesh allows them."""
    dp, tp = payload["mesh"]
    mesh = make_mesh(dp, tp, device_type="cpu")
    out = {route: route_loss_and_grad(mesh, payload, route) for route in payload["routes"]}
    out["errors"] = raised_errors(mesh, payload)
    if payload.get("hmc"):
        out["hmc"] = hmc_check(mesh, payload)
    if payload.get("resample"):
        out["resample"] = resample_check(mesh, payload)
    out["coords"] = mesh.get_coordinate()
    return out


def raised_errors(mesh, payload):
    """The messages of the three ValueErrors make_pathwise_train_step raises
    (None where this mesh cannot raise it)."""
    encoder, objective, spec = task()
    policy = svgp_from_numpy(payload["policy"], CPU, F64)
    drift = svgp_from_numpy(payload["drift"], CPU, F64)
    ens = gpr_ensemble_from_numpy(payload["ensemble"], CPU, F64)
    opt = torch.optim.Adam(policy.parameters(), lr=1e-2)
    cases = {
        "tp": (drift, BATCH, dict(fused_rollout=True)),
        "batch": (ens, BATCH + 1, dict()),
        "fused_ensemble": (ens, BATCH, dict(fused=True)),
    }
    out = {}
    for name, (model, batch, kw) in cases.items():
        try:
            make_pathwise_train_step(mesh, model, policy_chain, encoder, objective, spec, batch_size=batch,
                                     num_bases=BASES, optimizer=opt, dtype=F64, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def hmc_log_prob(q):
    z = q - torch.tensor(HMC_MEAN, dtype=q.dtype)
    return -0.5 * torch.sum(z * z, -1)


def hmc_check(mesh, payload):
    q_init = torch.as_tensor(payload["hmc_init"], dtype=F64)
    gen = torch.Generator().manual_seed(1)
    if mesh is None:
        res = run_hmc(hmc_log_prob, q_init, gen, HMC)
    else:
        res = run_hmc_sharded(hmc_log_prob, q_init, gen, mesh, HMC)
    return dict(samples=res.samples, accept=res.accept_prob, step_size=float(res.step_size),
                final_logp=res.final_logp)


def resample_check(mesh, payload):
    weights = torch.as_tensor(payload["weights"], dtype=F64)
    particles = {"x": torch.arange(weights.shape[0], dtype=F64)[:, None]}
    u0 = torch.tensor(payload["u0"], dtype=F64)
    if mesh is None:
        return systematic_resample(None, weights, particles, u0=u0)["x"]
    rows = particle_slab(mesh, weights.shape[0])
    drawn = systematic_resample_sharded(torch.Generator().manual_seed(3), weights[rows],
                                        {"x": particles["x"][rows]}, mesh)["x"]
    given = systematic_resample_sharded(None, weights[rows], {"x": particles["x"][rows]}, mesh, u0=u0)["x"]
    local = systematic_resample(torch.Generator().manual_seed(3), weights, particles)["x"][rows]
    return dict(given=given, drawn=drawn, local_drawn=local)
