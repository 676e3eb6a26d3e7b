"""Sharded pathwise policy training: particles over ``dp``, Fourier bases
over ``tp`` (counterpart of gpflowpilco_tpu/parallel/pathwise.py).

Every rank draws the global paths and initial states from a generator
seeded alike on every rank and keeps its slab, so a run on N ranks computes
what one rank computes, to rounding. The traffic is (a) the RFF prior's
partial sum over this rank's bases, summed over ``tp`` at every drift
evaluation, and (b) the particle loss and the policy gradient, summed over
``dp`` once a step. The rollouts themselves are independent.

The ``tp`` sum is a pair of autograd functions, as in tensor-parallel
layers: the drift's input enters the basis-split prior through
``_SumGradsOver`` (identity forward, the cotangent summed over ``tp``
backward) and the prior's partial leaves through ``_SumOver`` (summed
forward, identity backward). Every ``tp`` rank then holds the whole
gradient, so policy gradients are summed over ``dp`` only.
(``torch.distributed.nn.functional.all_reduce`` would sum the cotangent in
the backward as well, scaling the gradients by ``tp``.)
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..loops.pilco import fused_rollout_costs, particle_rollout_costs
from ..models.builders import policy_mask
from ..models.gp import SVGP, GPREnsemble
from ..models.pathwise import (
    PathState,
    PathwiseGPRTransform,
    PathwiseSVGPTransform,
    _prior_at,
    _update_at,
    generate_paths_gpr,
    generate_paths_svgp,
    mix_latents,
)
from .mesh import axis_size, basis_slab, particle_slab


class _SumOver(torch.autograd.Function):
    """Sum over a process group in the forward, identity in the backward:
    every rank of the group goes on to compute the same value from it."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradsOver(torch.autograd.Function):
    """Identity in the forward, the cotangent summed over a process group in
    the backward: the input of a computation split over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def allreduce_gradients(params: Iterable[torch.Tensor], group) -> None:
    """Sum the gradients of ``params`` over ``group``, in one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, piece in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(piece.view_as(g))


class _BasisSplitSVGPPaths:
    """SVGP paths whose basis axis is this rank's slab of ``num_bases``:
    the prior's partial sum is summed over ``group``; the canonical update,
    over all inducing points, is computed whole on every rank."""

    def __init__(self, model: SVGP, paths: PathState, num_bases: int, group):
        self.model, self.paths, self.num_bases, self.group = model, paths, num_bases, group

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        p = self.paths
        part = _prior_at(self.model.kernel, p.omega, p.phase, p.w, _SumGradsOver.apply(x, self.group),
                         self.num_bases)
        prior = _SumOver.apply(part, self.group)
        return mix_latents(self.model, prior + _update_at(self.model, p.v, x))


def make_pathwise_train_step(
    mesh: DeviceMesh,
    drift_model,
    policy_chain_fn: Callable,
    encoder,
    objective,
    episode_spec,
    batch_size: int,
    num_bases: int,
    optimizer: torch.optim.Optimizer,
    dtype: torch.dtype = torch.float32,
    fused: bool = False,
    fused_rollout: bool = False,
    action_scale: float = 10.0,
):
    """(train_step, loss_fn) of the particle rollout split over ``mesh``.

    ``train_step(policy_model, generator)`` draws the step's paths and
    initial states, takes one ``optimizer`` step on the policy (built over
    its parameters) and returns the loss. ``loss_fn(policy_model,
    generator=None, paths=None, x0=None)`` is the mean particle loss over
    all ranks, on the given global paths and x0 (batch_size, D) or on
    draws from ``generator`` (paths first, then x0, as
    ``PathwisePILCO.policy_loss_fn`` draws them); its backward leaves on
    each rank the gradient of that rank's particles, which ``train_step``
    sums over ``dp``.

    Routes: (a) the plain per-step rollout, particles on ``dp`` and bases
    on ``tp``; (b) ``fused=True``: each ``dp`` rank evaluates its particles'
    drifts through the path-eval kernel op with the whole basis; (c)
    ``fused_rollout=True``: each ``dp`` rank runs its particles' whole
    rollout through the rollout kernel op (``tp`` must be 1), on the
    policy's trainable parameters (``policy_mask``; the op refuses a
    frozen operand that asks for a gradient); (d) a ``GPREnsemble`` drift,
    plain or through the rollout kernel op: the particle budget splits
    over the K members, batch_size // K each, members replicated and each
    member's particles split over ``dp`` (x0 member-major). ``tp`` ranks
    of routes (b)-(d) compute the same values."""
    num_steps = episode_spec.num_steps
    dp, tp = axis_size(mesh, "dp"), axis_size(mesh, "tp")
    dp_group = mesh.get_group("dp")
    tp_group = mesh.get_group("tp")
    if fused_rollout and tp != 1:
        raise ValueError(
            "fused_rollout splits particles only (the rollout kernel holds the whole Fourier "
            "basis); build the mesh with tp=1"
        )
    is_ensemble = isinstance(drift_model, GPREnsemble)
    if is_ensemble:
        k_m = drift_model.num_members
        if batch_size % (k_m * dp):
            raise ValueError(
                f"batch_size ({batch_size}) must divide num_members*dp ({k_m}*{dp}) for the "
                "ensemble-sharded step"
            )
        s_per = batch_size // k_m
        if fused:
            raise ValueError(
                "the per-step fused drift kernel supports SVGP drifts only; use fused_rollout=True "
                "(whole-rollout kernel, GPR-capable) or fused=False for a GPREnsemble"
            )
        model = drift_model.members
        device = model.x.device
    else:
        model = drift_model
        device = model.z.device

    def draw_paths(generator):
        if is_ensemble:
            return generate_paths_gpr(model, generator, s_per, num_bases)
        return generate_paths_svgp(model, generator, batch_size, num_bases)

    def local_costs(policy_model, paths: PathState, x0: torch.Tensor) -> torch.Tensor:
        """This rank's particles' cumulative costs."""
        if is_ensemble:
            rows = particle_slab(mesh, s_per)
            # each member's slab stays in that member's slot: (K, s_per / dp)
            local = PathState(paths.omega, paths.phase, paths.w[:, rows], paths.v[:, rows])
            x_l = x0.reshape(k_m, s_per, -1)[:, rows].reshape(-1, x0.shape[-1])
            if fused_rollout:
                return fused_rollout_costs(policy_model, model, local, x_l, encoder, objective,
                                           action_scale, num_steps)
            drift_fn = PathwiseGPRTransform(model, local)
        else:
            rows = particle_slab(mesh, batch_size)
            x_l = x0[rows]
            if fused or fused_rollout or tp == 1:
                local = PathState(paths.omega, paths.phase, paths.w[rows], paths.v[rows])
                if fused_rollout:
                    return fused_rollout_costs(policy_model, model, local, x_l, encoder, objective,
                                               action_scale, num_steps)
                drift_fn = PathwiseSVGPTransform(model, local, fused=fused)
            else:
                b = basis_slab(mesh, num_bases)
                local = PathState(paths.omega[:, b], paths.phase[:, b], paths.w[rows][:, :, b], paths.v[rows])
                drift_fn = _BasisSplitSVGPPaths(model, local, num_bases, tp_group)
        return particle_rollout_costs(policy_chain_fn(policy_model), drift_fn, x_l, encoder, objective,
                                      num_steps)

    def loss_fn(policy_model, generator: Optional[torch.Generator] = None,
                paths: Optional[PathState] = None, x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        if paths is None:
            paths = draw_paths(generator)
        if x0 is None:
            x0 = episode_spec.sample(generator, (batch_size,), dtype=dtype, device=device)
        return _SumOver.apply(local_costs(policy_model, paths, x0).sum(), dp_group) / batch_size

    def train_step(policy_model, generator: torch.Generator) -> torch.Tensor:
        if fused_rollout:
            policy_mask(policy_model)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(policy_model, generator)
        loss.backward()
        allreduce_gradients(policy_model.parameters(), dp_group)
        optimizer.step()
        return loss.detach()

    return train_step, loss_fn
