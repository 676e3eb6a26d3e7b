"""Task components: feature encoder and Gaussian cost
(counterpart of gpflowpilco_tpu/components.py).

Only concrete evaluation is ported; the encoder's moment rule and the cost's
expectation under Gaussian moments arrive with moment-matching PILCO.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .moment_matching.rules import SinCos


class Encoder:
    """Apply ``transform`` to the active dims and append the untouched dims."""

    def __init__(self, transform, active_dims: Tuple[int, ...] = ()):
        self.transform = transform
        self.active_dims = tuple(active_dims)
        self._indices = {}  # (ndims, device) -> (active, inactive) index tensors

    def partition(self, ndims: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        active = self.active_dims
        if len(set(active)) != len(active):
            raise ValueError(f"repeated active dims {active}")
        inactive = tuple(i for i in range(ndims) if i not in set(active))
        return active, inactive

    def _index(self, ndims: int, device):
        # index tensors made once per device: a Python list index would be
        # copied from the host on every call
        key = (ndims, device)
        if key not in self._indices:
            self._indices[key] = tuple(
                torch.tensor(ix, dtype=torch.long, device=device) for ix in self.partition(ndims)
            )
        return self._indices[key]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        active, inactive = self._index(x.shape[-1], x.device)
        out = self.transform(torch.index_select(x, -1, active))
        if inactive.numel():
            out = torch.cat([out, torch.index_select(x, -1, inactive)], dim=-1)
        return out


def trigonometric_encoder(active_dims: Tuple[int, ...]) -> Encoder:
    """Encoder(sincos)."""
    return Encoder(transform=SinCos(), active_dims=tuple(active_dims))


class GaussianObjective:
    """cost(x) = -exp(-0.5 (x - target)^T precis (x - target))."""

    def __init__(self, target: torch.Tensor, precis: torch.Tensor):
        self.target = target  # (D,)
        self.precis = precis  # (D, D)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        err = x - self.target
        dist2 = torch.sum(err * torch.einsum("ij,...j->...i", self.precis, err), dim=-1)
        return -torch.exp(-0.5 * dist2)
