"""Gaussian moment containers and transform composition
(counterpart of gpflowpilco_tpu/moments.py).

Covariances are dense and centred; leading batch dimensions broadcast: mean
(..., D), cov (..., D, D). The cross-covariance of a match may be stored
pre-multiplied by Cov(x,x)^{-1} (``preinv=True``), so chained matches
compose by plain products without solves; for elementary transforms that
pre-multiplied cross is E[Jacobian] (Stein's lemma).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .ops.linalg import bcho_solve, cholesky_nan


@dataclass(frozen=True)
class GaussianMoments:
    """A Gaussian by mean (..., D) and covariance (..., D, D)."""

    mean: torch.Tensor
    cov: torch.Tensor

    @property
    def ndim(self) -> int:
        return self.mean.shape[-1]

    @property
    def dtype(self):
        return self.mean.dtype

    def variance(self) -> torch.Tensor:
        return torch.diagonal(self.cov, dim1=-2, dim2=-1)


@dataclass(frozen=True)
class GaussianMatch:
    """A moment-matched pair: base measure ``x``, push-forward ``y``, and
    their cross-covariance Cov(x, y), stored raw or pre-multiplied by
    Cov(x,x)^{-1}."""

    x: GaussianMoments
    y: GaussianMoments
    cross: torch.Tensor  # (..., Dx, Dy); premultiplied by Sxx^{-1} iff preinv
    preinv: bool

    def cross_covariance(self, preinv: bool = False) -> torch.Tensor:
        if preinv == self.preinv:
            return self.cross
        if not preinv:
            return self.x.cov @ self.cross
        # preinv requested but stored raw: solve Sxx^{-1} Sxy
        return bcho_solve(cholesky_nan(self.x.cov), self.cross)

    def joint(self) -> GaussianMoments:
        """Gaussian approximation to the joint distribution of (x, y)."""
        sxy = self.cross_covariance(preinv=False)
        top = torch.cat([self.x.cov, sxy], dim=-1)
        bot = torch.cat([sxy.mT, self.y.cov], dim=-1)
        return GaussianMoments(
            mean=torch.cat([self.x.mean, self.y.mean], dim=-1), cov=torch.cat([top, bot], dim=-2)
        )


def psd_project(x: GaussianMoments, min_eig: float = 0.0) -> GaussianMoments:
    """Project the covariance onto the PSD cone by a stop-gradient eigenvalue
    boost: S <- sym(S) + max(-lambda_min + min_eig, 0) I. Linearized moment
    compositions are not guaranteed PSD, and an indefinite covariance makes
    the next Cholesky fail; the boost leaves the gradient geometry as it is."""
    cov = 0.5 * (x.cov + x.cov.mT)
    lam_min = torch.linalg.eigvalsh(cov.detach()).amin(dim=-1)
    boost = torch.clamp(min_eig - lam_min, min=0.0)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return GaussianMoments(mean=x.mean, cov=cov + boost[..., None, None] * eye)


class Chain(tuple):
    """Composite transform applying ops right-to-left: Chain(f, g)(x) = f(g(x))."""

    def __new__(cls, *ops):
        return super().__new__(cls, ops)

    def __call__(self, x):
        for op in reversed(self):
            x = op(x)
        return x

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        """Linear (conditional-expectation) composition of matches: the first
        match's cross is kept with its preinv convention; every later stage
        right-multiplies its pre-multiplied cross."""
        state, cross, preinv = x, None, None
        for i, op in enumerate(reversed(self)):
            match = op.moment_match(state)
            state = match.y
            if i == 0:
                cross, preinv = match.cross, match.preinv
            else:
                cross = cross @ match.cross_covariance(preinv=True)
        return GaussianMatch(x=x, y=state, cross=cross, preinv=preinv)


@dataclass(frozen=True)
class DtypeIsland:
    """Run ``inner``'s match and evaluation at ``dtype`` inside a composition
    that runs at ``outer``: moments are cast down on entry and the match is
    cast back up on exit, with the casts in the autograd graph both ways. The
    returned match keeps the OUTER ``x``, so preinv conversions and joints
    stay at the outer precision. The MM loss uses it to keep the policy chain
    at the loop's float32 inside a float64 loss."""

    inner: object  # a transform: __call__ on tensors, moment_match on moments
    dtype: torch.dtype  # island compute dtype
    outer: torch.dtype  # composition dtype

    def __call__(self, x):
        return self.inner(x.to(self.dtype)).to(self.outer)

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        m = self.inner.moment_match(
            GaussianMoments(mean=x.mean.to(self.dtype), cov=x.cov.to(self.dtype))
        )
        y = GaussianMoments(mean=m.y.mean.to(self.outer), cov=m.y.cov.to(self.outer))
        return GaussianMatch(x=x, y=y, cross=m.cross.to(self.outer), preinv=m.preinv)
