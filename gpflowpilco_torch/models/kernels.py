"""Squared-exponential kernel with latent-stacked parameters
(counterpart of gpflowpilco_tpu/models/kernels.py).

A multioutput kernel is one ``RBF`` whose parameters carry a leading latent
axis L: variance (L,), lengthscales (L, D). ``SharedRBF`` ties one
hyperparameter set across the L latents.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils import bijectors as bij


def _raw_parameters(variance, lengthscales, ls_low, ls_high):
    """The unconstrained (raw variance, raw lengthscales) of an RBF."""
    if ls_low is None:
        return bij.positive_inv(variance), bij.positive_inv(lengthscales)
    return bij.positive_inv(variance), bij.sigmoid_interval_inv(lengthscales, ls_low, ls_high)


class RBF(nn.Module):
    """k(a, b) = variance * exp(-0.5 * sum_d ((a_d - b_d) / lengthscales_d)^2).

    ``raw_*`` are the unconstrained ``nn.Parameter``s: ``variance`` is a
    shifted softplus and ``lengthscales`` a sigmoid onto (ls_low, ls_high),
    or a shifted softplus when ``ls_low`` is None.
    """

    def __init__(
        self,
        raw_variance: torch.Tensor,
        raw_lengthscales: torch.Tensor,
        ls_low: Optional[float] = 0.01,
        ls_high: Optional[float] = 100.0,
    ):
        super().__init__()
        self.raw_variance = nn.Parameter(raw_variance)
        self.raw_lengthscales = nn.Parameter(raw_lengthscales)
        self.ls_low = ls_low
        self.ls_high = ls_high

    @property
    def variance(self) -> torch.Tensor:
        return bij.positive(self.raw_variance)

    @property
    def lengthscales(self) -> torch.Tensor:
        if self.ls_low is None:
            return bij.positive(self.raw_lengthscales)
        return bij.sigmoid_interval(self.raw_lengthscales, self.ls_low, self.ls_high)

    @classmethod
    def create(
        cls,
        variance: torch.Tensor,
        lengthscales: torch.Tensor,
        ls_low: Optional[float] = 0.01,
        ls_high: Optional[float] = 100.0,
    ) -> "RBF":
        raw_v, raw_l = _raw_parameters(variance, lengthscales, ls_low, ls_high)
        return cls(raw_v, raw_l, ls_low=ls_low, ls_high=ls_high)

    def gram(self, a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Dense Gram matrix: a (..., N, D), b (..., M, D) -> (..., N, M).

        Uses the direct (a-b)^2 form, not the inner-product expansion, so the
        factorizations of grams whose smallest eigenvalues sit at the jitter
        floor see no cancellation error.
        """
        if b is None:
            b = a
        ls = self.lengthscales
        if ls.dim() == 0:
            ls = ls[None]
        sa = a / ls[..., None, :]
        sb = b / ls[..., None, :]
        diff = sa[..., :, None, :] - sb[..., None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
        return self.variance[..., None, None] * torch.exp(-0.5 * d2)


class SharedRBF(RBF):
    """One set of RBF hyperparameters shared by all ``num_outputs`` latent
    GPs. The raw parameters are unstacked (variance (), lengthscales (D,));
    ``variance`` and ``lengthscales`` broadcast them to (L,) and (L, D), so
    every latent-stacked consumer works unchanged, and autograd sums the
    per-latent gradients onto the shared parameter."""

    def __init__(
        self,
        raw_variance: torch.Tensor,
        raw_lengthscales: torch.Tensor,
        num_outputs: int,
        ls_low: Optional[float] = 0.01,
        ls_high: Optional[float] = 100.0,
    ):
        super().__init__(raw_variance, raw_lengthscales, ls_low=ls_low, ls_high=ls_high)
        self.num_outputs = num_outputs

    @property
    def variance(self) -> torch.Tensor:
        return super().variance.expand(self.num_outputs).contiguous()

    @property
    def lengthscales(self) -> torch.Tensor:
        ls = super().lengthscales
        return ls[None].expand((self.num_outputs,) + ls.shape).contiguous()

    @classmethod
    def create_shared(
        cls,
        variance: torch.Tensor,
        lengthscales: torch.Tensor,
        num_outputs: int,
        ls_low: Optional[float] = 0.01,
        ls_high: Optional[float] = 100.0,
    ) -> "SharedRBF":
        raw_v, raw_l = _raw_parameters(variance, lengthscales, ls_low, ls_high)
        return cls(raw_v, raw_l, num_outputs, ls_low=ls_low, ls_high=ls_high)


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j||^2 by the inner-product expansion, clamped at 0."""
    aa = torch.sum(a * a, dim=-1)
    bb = torch.sum(b * b, dim=-1)
    ab = torch.einsum("...nd,...md->...nm", a, b)
    d2 = aa[..., :, None] + bb[..., None, :] - 2.0 * ab
    return torch.clamp(d2, min=0.0)
