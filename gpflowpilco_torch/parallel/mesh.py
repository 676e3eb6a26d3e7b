"""Device meshes for multi-process PILCO (counterpart of
gpflowpilco_tpu/parallel/mesh.py).

Two axes: ``dp`` carries the particles (each rollout rides its own sampled
dynamics function, so they are embarrassingly parallel) and ``tp`` the
Fourier bases of the sampled paths (the RFF contraction splits over bases
and is summed over ``tp``). The JAX package places arrays by sharding
annotations; here every rank holds whole tensors and keeps its slab of
them: ``particle_slab`` and ``basis_slab`` are the counterparts of
``particle_sharding`` and of the replicated layout's basis split.

The process group is the caller's: ``torch.distributed.init_process_group``
with the address, the world size and the rank. A ``cuda`` mesh runs on
NCCL, or on gloo where the caller names it (two ranks on one card, which
NCCL refuses); a ``cpu`` mesh runs on gloo. Nothing falls back to another
backend or device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import default_device


def make_mesh(dp: Optional[int] = None, tp: int = 1, device_type: Optional[str] = None,
              backend: Optional[str] = None) -> DeviceMesh:
    """A ("dp", "tp") mesh over every rank of the initialized process group:
    dp = particle data-parallel, tp = basis tensor-parallel; dp defaults to
    world_size // tp. ``device_type`` defaults to ``default_device()``'s
    (cuda); ``backend`` names the process group's backend where it is not
    the device's own (nccl for cuda, gloo for cpu)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (torch.distributed.init_process_group)")
    device_type = default_device(device_type).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device; pass device_type='cpu' for a CPU mesh")
    want = backend or ("nccl" if device_type == "cuda" else "gloo")
    if dist.get_backend() != want:
        raise ValueError(f"a {device_type} mesh runs on {want}, and the process group is {dist.get_backend()}")
    n = dist.get_world_size()
    if dp is None:
        assert n % tp == 0, (n, tp)
        dp = n // tp
    assert dp * tp <= n, (dp, tp, n)
    if dp * tp != n:
        raise ValueError(f"the mesh spans every rank: dp * tp = {dp * tp}, world size {n}")
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"),
                            backend_override={"dp": want, "tp": want})


def _slab(mesh: DeviceMesh, axis: str, n: int) -> slice:
    size, rank = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    if n % size:
        raise ValueError(f"{n} does not split evenly over {axis} = {size}")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def particle_slab(mesh: DeviceMesh, n: int) -> slice:
    """This rank's rows of a leading particle axis of length n, split over dp."""
    return _slab(mesh, "dp", n)


def basis_slab(mesh: DeviceMesh, num_bases: int) -> slice:
    """This rank's entries of a Fourier-basis axis, split over tp."""
    return _slab(mesh, "tp", num_bases)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))
