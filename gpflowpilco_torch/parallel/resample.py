"""Systematic particle resampling, local and split over the mesh's ``dp``
axis (counterpart of gpflowpilco_tpu/parallel/resample.py).

One uniform u0 ~ U[0, 1/S); the positions (i + u0) / S are inverted through
the weights' CDF. Split over ``dp``: the weights and the particles are
all-gathered (S x D floats for PILCO states) and each rank keeps its slab
of the output. The draw of u0 is ``draw_u0`` alone, so a caller can pass
another source's u0 instead.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import particle_slab


def draw_u0(generator: Optional[torch.Generator], num: int, dtype, device) -> torch.Tensor:
    """The offset u0 ~ U[0, 1/num) of a systematic resampling of num particles."""
    return torch.rand((), generator=generator, dtype=dtype, device=device) / num


def _map(fn, tree):
    """``fn`` on every tensor of a tensor, or a dict, list or tuple of them."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _indices(weights: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    cdf = torch.cumsum(weights / torch.sum(weights), 0)
    return torch.clamp(torch.searchsorted(cdf, positions), 0, weights.shape[0] - 1)


def systematic_resample_indices(generator: Optional[torch.Generator], weights: torch.Tensor,
                                u0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S,) weights, normalized or not -> (S,) ancestor indices; u0 is drawn
    from ``generator`` unless given."""
    s = weights.shape[0]
    if u0 is None:
        u0 = draw_u0(generator, s, weights.dtype, weights.device)
    positions = u0 + torch.arange(s, dtype=weights.dtype, device=weights.device) / s
    return _indices(weights, positions)


def systematic_resample(generator: Optional[torch.Generator], weights: torch.Tensor, particles,
                        u0: Optional[torch.Tensor] = None):
    """Resample particles (a tensor with leading axis S, or a dict, list or
    tuple of them) by systematic resampling."""
    idx = systematic_resample_indices(generator, weights, u0)
    return _map(lambda a: a[idx], particles)


def systematic_resample_sharded(generator: Optional[torch.Generator], local_weights: torch.Tensor,
                                local_particles, mesh: DeviceMesh, u0: Optional[torch.Tensor] = None):
    """This rank's (S_local,) weights and (S_local, ...) particles of S
    split over dp -> this rank's output slab of a resampling of all S,
    the same as ``systematic_resample`` of the gathered weights and
    particles. Every rank must draw the same u0 (a generator seeded alike)."""
    group = mesh.get_group("dp")
    world = dist.get_world_size(group)

    def gather(a):
        parts = [torch.empty_like(a) for _ in range(world)]
        dist.all_gather(parts, a.contiguous(), group=group)
        return torch.cat(parts)

    weights = gather(local_weights)
    s = weights.shape[0]
    if u0 is None:
        u0 = draw_u0(generator, s, weights.dtype, weights.device)
    rows = particle_slab(mesh, s)
    offs = torch.arange(rows.start, rows.stop, dtype=weights.dtype, device=weights.device)
    src = _indices(weights, u0 + offs / s)
    return _map(lambda a: gather(a)[src], local_particles)
