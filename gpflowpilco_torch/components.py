"""Task components: feature encoder and Gaussian cost
(counterpart of gpflowpilco_tpu/components.py).

Both evaluate concretely and on GaussianMoments. The encoder's fused match
(the TPU kernel K4, ``Encoder(fused=True)``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .moment_matching.rules import SinCos
from .moments import GaussianMatch, GaussianMoments
from .ops.linalg import bcho_solve, cholesky_nan


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

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        """Partition x into (active a, inactive b), match the transform on a,
        and stitch the joint covariance back together. Cov(x, T(a)) =
        Cov(x, a) Saa^{-1} Cov(a, T(a)) is exact by Stein's lemma."""
        a_idx, b_idx = self._index(x.ndim, x.mean.device)
        mean_a = torch.index_select(x.mean, -1, a_idx)
        sxa = torch.index_select(x.cov, -1, a_idx)  # (..., D, Da)
        saa = torch.index_select(sxa, -2, a_idx)  # (..., Da, Da)
        match_t = self.transform.moment_match(GaussianMoments(mean=mean_a, cov=saa))
        sxy_t = sxa @ match_t.cross_covariance(preinv=True)  # (..., D, Dy)
        if not b_idx.numel():
            return GaussianMatch(x=x, y=match_t.y, cross=sxy_t, preinv=False)

        mean_b = torch.index_select(x.mean, -1, b_idx)
        sxb = torch.index_select(x.cov, -1, b_idx)  # (..., D, Db)
        sbb = torch.index_select(sxb, -2, b_idx)  # (..., Db, Db)
        sby = torch.index_select(sxy_t, -2, b_idx)  # (..., Db, Dy)
        top = torch.cat([match_t.y.cov, sby.mT], dim=-1)
        bot = torch.cat([sby, sbb], dim=-1)
        y = GaussianMoments(
            mean=torch.cat([match_t.y.mean, mean_b], dim=-1), cov=torch.cat([top, bot], dim=-2)
        )
        cross = torch.cat([sxy_t, sxb], dim=-1)  # (..., D, Dy + Db)
        return GaussianMatch(x=x, y=y, cross=cross, preinv=False)


def trigonometric_encoder(active_dims: Tuple[int, ...]) -> Encoder:
    """Encoder(sincos)."""
    return Encoder(transform=SinCos(), active_dims=tuple(active_dims))


class GaussianObjective:
    """cost(x) = -exp(-0.5 (x - target)^T precis (x - target)).

    On GaussianMoments it gives the exact expectation through (I + S W)^{-1}
    algebra. With ``precis_sqrt`` (B = W^{1/2}, see ``create``) the LU solve
    and log-determinant become one Cholesky of A = I + B S B, whose
    eigenvalues are >= 1: det(I + S W) = det(A) and W (I + S W)^{-1} =
    B A^{-1} B. The tensors are cast to the moments' dtype, so the cost
    follows the loss dtype.
    """

    def __init__(
        self, target: torch.Tensor, precis: torch.Tensor, precis_sqrt: Optional[torch.Tensor] = None
    ):
        self.target = target  # (D,)
        self.precis = precis  # (D, D)
        self.precis_sqrt = precis_sqrt  # optional symmetric PSD square root of precis

    @classmethod
    def create(cls, target, precis) -> "GaussianObjective":
        """Precompute the symmetric PSD square root once, at build time."""
        w, v = torch.linalg.eigh(precis)
        b = (v * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]) @ v.mT
        return cls(target=target, precis=precis, precis_sqrt=b)

    def __call__(self, x) -> torch.Tensor:
        if isinstance(x, GaussianMoments):
            return self._expected(x)
        err = x - self.target
        dist2 = torch.sum(err * torch.einsum("ij,...j->...i", self.precis, err), dim=-1)
        return -torch.exp(-0.5 * dist2)

    def _expected(self, x: GaussianMoments) -> torch.Tensor:
        """E[cost] under x ~ N(mean, cov)."""
        dtype = x.dtype
        err = x.mean - self.target.to(dtype)  # (..., D)
        eye = torch.eye(err.shape[-1], dtype=dtype, device=err.device)
        if self.precis_sqrt is not None:
            b = self.precis_sqrt.to(dtype)
            chol = cholesky_nan(eye + b @ x.cov @ b)
            berr = torch.einsum("ij,...j->...i", b, err)
            u = bcho_solve(chol, berr[..., None])[..., 0]
            dist2 = torch.sum(berr * u, dim=-1)
            logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
            return -torch.exp(-0.5 * (logdet + dist2))
        precis = self.precis.to(dtype)
        ipsw = eye + x.cov @ precis  # (..., D, D)
        u = torch.linalg.solve(ipsw, err[..., None])[..., 0]  # (I+SW)^{-1} err
        dist2 = torch.sum(err * torch.einsum("ij,...j->...i", precis, u), dim=-1)
        logdet = torch.linalg.slogdet(ipsw)[1]
        return -torch.exp(-0.5 * (logdet + dist2))
