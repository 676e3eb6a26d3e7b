"""HMC chains split over the mesh's ``dp`` axis (counterpart of
gpflowpilco_tpu/parallel/hmc.py).

Each rank runs its slab of the chains. The only traffic is the warmup's
cross-chain means (the mean acceptance of the step-size adaptation, and
ChEES's signal), each an all-reduce over ``dp`` divided by the global chain
count.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.hmc import HMCConfig, HMCResult, run_hmc
from .mesh import particle_slab


def run_hmc_sharded(
    log_prob_fn,
    q_init: torch.Tensor,
    generator: torch.Generator,
    mesh: DeviceMesh,
    config: HMCConfig = HMCConfig(),
) -> HMCResult:
    """``run_hmc`` on this rank's chains: q_init (C, dim) holds all C chains'
    starting points and the result this rank's rows of them
    (``particle_slab(mesh, C)``). Every rank draws the randoms of all C
    chains from ``generator`` (seeded alike on every rank) and keeps its
    slab, so the samples equal an unsharded run's to rounding."""
    num_chains = q_init.shape[0]
    rows = particle_slab(mesh, num_chains)
    group = mesh.get_group("dp")

    def chain_mean(x):
        total = x.sum(0)
        dist.all_reduce(total, group=group)
        return total / num_chains

    return run_hmc(log_prob_fn, q_init[rows], generator, config, chain_mean=chain_mean,
                   chain_rows=(rows, num_chains))
