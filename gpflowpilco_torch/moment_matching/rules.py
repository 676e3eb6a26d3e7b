"""Closed-form Gaussian moment-matching rules for elementary transforms
(counterpart of gpflowpilco_tpu/moment_matching/rules.py).

Each transform has ``__call__`` on tensors and ``moment_match`` on
GaussianMoments. Rules return centred second moments and, where exact,
pre-multiplied crosses (Stein's lemma: Sxx^{-1} Cov(x, g(x)) = E[dg/dx]).

Trig identities, for x ~ N(m, S), v = diag(S), A = exp(-(v_i+v_j+2S_ij)/2),
B = exp(-(v_i+v_j-2S_ij)/2):

    E[sin x_i]          = e^{-v_i/2} sin m_i
    E[cos x_i]          = e^{-v_i/2} cos m_i
    E[sin x_i sin x_j]  = (B cos(m_i-m_j) - A cos(m_i+m_j)) / 2
    E[cos x_i cos x_j]  = (B cos(m_i-m_j) + A cos(m_i+m_j)) / 2
    E[sin x_i cos x_j]  = (B sin(m_i-m_j) + A sin(m_i+m_j)) / 2

The probit rule (policy squash): for y = Phi(x), h_i = m_i / sqrt(1+v_i),
rho_ij = S_ij / sqrt((1+v_i)(1+v_j)): E[y_i] = Phi(h_i), E[y_i y_j] =
Phi_2(h_i, h_j, rho_ij) (Genz BVN), Sxx^{-1} Cov(x, y) = diag(phi(h) /
sqrt(1+v)).
"""
from __future__ import annotations

import math

import torch

from ..moments import Chain, GaussianMatch, GaussianMoments
from ..ops.bvn import bvnu, ndtr


def sincos(x, dim: int = -1):
    """concat[sin x, cos x]."""
    return torch.cat([torch.sin(x), torch.cos(x)], dim=dim)


def _eye(x: GaussianMoments):
    return torch.eye(x.ndim, dtype=x.dtype, device=x.mean.device)


def _vector(c, x: GaussianMoments):
    """A scalar or vector parameter as a (D,) tensor of x's dtype and device."""
    return torch.as_tensor(c, dtype=x.dtype, device=x.mean.device).expand(x.ndim)


class Identity:
    def __call__(self, x):
        return x

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        return GaussianMatch(x=x, y=x, cross=_eye(x), preinv=True)


class Shift:
    """y = x + c."""

    def __init__(self, shift):
        self.shift = shift

    def __call__(self, x):
        return x + self.shift

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        y = GaussianMoments(mean=x.mean + self.shift, cov=x.cov)
        return GaussianMatch(x=x, y=y, cross=_eye(x), preinv=True)


class Scale:
    """y = c * x, elementwise."""

    def __init__(self, scale):
        self.scale = scale

    def __call__(self, x):
        return self.scale * x

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        c = _vector(self.scale, x)
        y = GaussianMoments(mean=c * x.mean, cov=x.cov * c[:, None] * c[None, :])
        return GaussianMatch(x=x, y=y, cross=torch.diag_embed(c), preinv=True)


class MatVec:
    """y = A x, with A (P, D)."""

    def __init__(self, matrix):
        self.matrix = matrix

    def __call__(self, x):
        return torch.einsum("pd,...d->...p", self.matrix, x)

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        a = self.matrix
        y = GaussianMoments(mean=self(x.mean), cov=torch.einsum("pd,...de,qe->...pq", a, x.cov, a))
        return GaussianMatch(x=x, y=y, cross=a.mT, preinv=True)


def _trig_terms(x: GaussianMoments):
    m, s = x.mean, x.cov
    # float32 moment propagation can leave tiny negative variances on the
    # diagonal; exp(-v/2) would blow up, so clamp at zero (exact when valid)
    v = torch.clamp(x.variance(), min=0.0)
    vpv = v[..., :, None] + v[..., None, :]
    spst = s + s.mT
    a = torch.exp(-0.5 * (vpv + spst))
    b = torch.exp(-0.5 * (vpv - spst))
    madd = m[..., :, None] + m[..., None, :]
    msub = m[..., :, None] - m[..., None, :]
    return m, a, b, madd, msub, torch.exp(-0.5 * v)


class Sin:
    def __call__(self, x):
        return torch.sin(x)

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        m, a, b, madd, msub, ev = _trig_terms(x)
        y1 = ev * torch.sin(m)
        raw2 = 0.5 * (b * torch.cos(msub) - a * torch.cos(madd))
        y = GaussianMoments(mean=y1, cov=raw2 - y1[..., :, None] * y1[..., None, :])
        return GaussianMatch(x=x, y=y, cross=torch.diag_embed(ev * torch.cos(m)), preinv=True)


class Cos:
    def __call__(self, x):
        return torch.cos(x)

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        m, a, b, madd, msub, ev = _trig_terms(x)
        y1 = ev * torch.cos(m)
        raw2 = 0.5 * (b * torch.cos(msub) + a * torch.cos(madd))
        y = GaussianMoments(mean=y1, cov=raw2 - y1[..., :, None] * y1[..., None, :])
        return GaussianMatch(x=x, y=y, cross=torch.diag_embed(-ev * torch.sin(m)), preinv=True)


class SinCos:
    """y = concat[sin x, cos x], with the exact sin-cos cross block."""

    def __call__(self, x):
        return sincos(x)

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        m, a, b, madd, msub, ev = _trig_terms(x)
        s1 = ev * torch.sin(m)
        c1 = ev * torch.cos(m)
        ss = 0.5 * (b * torch.cos(msub) - a * torch.cos(madd))
        cc = 0.5 * (b * torch.cos(msub) + a * torch.cos(madd))
        sc = 0.5 * (b * torch.sin(msub) + a * torch.sin(madd))  # E[sin x_i cos x_j]

        y1 = torch.cat([s1, c1], dim=-1)
        raw2 = torch.cat(
            [torch.cat([ss, sc], dim=-1), torch.cat([sc.mT, cc], dim=-1)], dim=-2
        )
        y = GaussianMoments(mean=y1, cov=raw2 - y1[..., :, None] * y1[..., None, :])
        cross = torch.cat([torch.diag_embed(c1), torch.diag_embed(-s1)], dim=-1)
        return GaussianMatch(x=x, y=y, cross=cross, preinv=True)


class Probit:
    """y = Phi(x), the standard-normal CDF, elementwise."""

    def __call__(self, x):
        return ndtr(x)

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        m, s = x.mean, x.cov
        v = torch.clamp(x.variance(), min=0.0)  # see _trig_terms
        isq_vw = torch.rsqrt(1.0 + v)
        h = m * isq_vw  # (..., D)
        y1 = ndtr(h)
        # any valid covariance gives |rho| <= 1, but float32 rounding of
        # v * rsqrt(1+v)^2 can land at 1 + ulp for large v (saturated
        # policies); clip so the BVN density derivative stays bounded
        rho = torch.clamp(s * isq_vw[..., :, None] * isq_vw[..., None, :], -1.0, 1.0)
        raw2 = bvnu(-h[..., :, None], -h[..., None, :], rho)
        y = GaussianMoments(mean=y1, cov=raw2 - y1[..., :, None] * y1[..., None, :])
        phi_h = torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi)
        return GaussianMatch(x=x, y=y, cross=torch.diag_embed(isq_vw * phi_h), preinv=True)


class SquashedProbit:
    """y = scale * (Phi(x) - 0.5): the PILCO policy squash
    Chain(Scale(scale), Shift(-0.5), Probit()) collapsed into one transform.
    The affine stages compose exactly: E[y] = c (E[Phi] - 1/2), Cov scales by
    c^2, the pre-multiplied cross by c."""

    def __init__(self, scale):
        self.scale = scale

    def __call__(self, x):
        return self.scale * (ndtr(x) - 0.5)

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        inner = Probit().moment_match(x)
        c = _vector(self.scale, x)
        y = GaussianMoments(
            mean=c * (inner.y.mean - 0.5), cov=inner.y.cov * c[:, None] * c[None, :]
        )
        return GaussianMatch(x=x, y=y, cross=inner.cross * c[None, :], preinv=True)


def moment_matching(x: GaussianMoments, op) -> GaussianMatch:
    """Push Gaussian moments through ``op``: any object with a
    ``moment_match`` method, or a ``Chain``."""
    if not (isinstance(op, Chain) or hasattr(op, "moment_match")):
        raise TypeError(f"{type(op).__name__} has no moment rule")
    return op.moment_match(x)
