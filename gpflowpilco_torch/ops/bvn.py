"""Bivariate-normal probabilities and related special functions
(counterpart of gpflowpilco_tpu/ops/bvn.py).

Genz's BVN algorithm with the order-20 Gauss-Legendre rule in every regime
(no data-dependent choice of order), and Owen's T by the same fixed
quadrature. Case analysis is ``torch.where`` on clamped operands. The
derivatives of ``bvnu`` are the exact closed forms, given by the
``autograd.Function`` below in place of the JAX package's custom JVP: the
quadrature's strong-correlation branch has unstable derivatives near
|r| -> 1, while the closed forms are bounded. All functions broadcast.
"""
from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)
_2PI = 2.0 * math.pi

# Order-20 Gauss-Legendre abscissae/weights on [-1, 1] (10 symmetric pairs).
_GL20_X = (
    0.9931285991850949, 0.9639719272779138, 0.9122344282513259,
    0.8391169718222188, 0.7463319064601508, 0.6360536807265150,
    0.5108670019508271, 0.3737060887154196, 0.2277858511416451,
    0.07652652113349733,
)
_GL20_W = (
    0.01761400713915212, 0.04060142980038694, 0.06267204833410906,
    0.08327674157670475, 0.1019301198172404, 0.1181945319615184,
    0.1316886384491766, 0.1420961093183821, 0.1491729864726037,
    0.1527533871307259,
)


def _gl20(like: torch.Tensor):
    """Nodes/weights of the 20-point rule mapped to t in (0, 2): t = 1 -/+ x."""
    x = torch.tensor(_GL20_X, dtype=like.dtype, device=like.device)
    w = torch.tensor(_GL20_W, dtype=like.dtype, device=like.device)
    return torch.cat([1.0 - x, 1.0 + x]), torch.cat([w, w])


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF, 0.5 erfc(-x / sqrt 2)."""
    return 0.5 * torch.special.erfc(-x / _SQRT2)


def owens_t(h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Owen's T(h, a) = (2 pi)^-1 int_0^a exp(-h^2 (1+t^2)/2) / (1+t^2) dt, by
    fixed-order Gauss-Legendre over [0, a]."""
    h, a = torch.broadcast_tensors(h, a)
    nodes, weights = _gl20(h)
    t = 0.5 * a[..., None] * nodes
    integrand = torch.exp(-0.5 * (h[..., None] ** 2) * (1.0 + t * t)) / (1.0 + t * t)
    return (0.5 / _2PI) * torch.sum(weights * integrand, dim=-1) * a


def _bvnu_finite(h, k, r):
    """P(X > h, Y > k) for a standard bivariate normal, finite h and k,
    |r| <= 1: Genz's two regimes with clamped branch operands."""
    hk = h * k
    itp = 1.0 / _2PI
    x, w = _gl20(h)
    tiny = 1e-30 if h.dtype == torch.float64 else 1e-18

    # ---- moderate-correlation regime: |r| <= 0.925
    asr = 0.5 * torch.asin(torch.clamp(r, -0.925, 0.925))
    sn = torch.sin(asr[..., None] * x)
    expo = (sn * hk[..., None] - 0.5 * (h * h + k * k)[..., None]) / (1.0 - sn * sn)
    mod = torch.sum(w * torch.exp(expo), dim=-1) * itp * asr + ndtr(-h) * ndtr(-k)

    # ---- strong-correlation regime: |r| > 0.925
    sgn = torch.where(r < 0, -1.0, 1.0).to(h.dtype)
    ks = k * sgn
    hks = hk * sgn
    r_str = torch.clamp(torch.abs(r), 0.925, 1.0) * sgn  # sanitized for unused lanes
    a2 = torch.clamp(1.0 - r_str * r_str, min=tiny)
    a = torch.sqrt(a2)
    bs = torch.clamp((h - ks) ** 2, min=tiny)
    b = torch.sqrt(bs)
    c = 0.125 * (4.0 - hks)
    d = 0.0125 * (12.0 - hks)

    asr1 = -0.5 * (bs / a2 + hks)
    term1 = torch.where(
        asr1 > -100.0,
        a * torch.exp(asr1) * (1.0 - c * (bs - a2) * (1.0 - d * bs) / 3.0 + c * d * a2 * a2),
        0.0,
    )
    sp = math.sqrt(_2PI) * ndtr(-b / a)
    term2 = torch.where(
        hks > -100.0,
        torch.exp(-0.5 * hks) * sp * b * (1.0 - c * bs * (1.0 - d * bs) / 3.0),
        0.0,
    )
    res = term1 - term2

    ah = 0.5 * a
    xs = (ah[..., None] * x) ** 2
    asr2 = -0.5 * (bs[..., None] / xs + hks[..., None])
    sp2 = 1.0 + c[..., None] * xs * (1.0 + 5.0 * d[..., None] * xs)
    rs = torch.sqrt(torch.clamp(1.0 - xs, min=tiny))
    ep = torch.exp(-0.5 * hks[..., None] * xs / (1.0 + rs) ** 2) / rs
    deltas = torch.where(asr2 > -100.0, w * torch.exp(asr2) * (sp2 - ep), 0.0)
    res = itp * (ah * torch.sum(deltas, dim=-1) - res)

    # the strong-correlation tail cases
    pos = res + ndtr(-torch.maximum(h, ks))
    neg = torch.where(
        h >= ks,
        -res,
        torch.where(h < 0, ndtr(ks) - ndtr(h) - res, ndtr(-h) - ndtr(-ks) - res),
    )
    strong = torch.where(r > 0, pos, neg)
    return torch.clamp(torch.where(torch.abs(r) < 0.925, mod, strong), 0.0, 1.0)


def _bvnu_value(h, k, r):
    """bvnu with infinite bounds handled by select; finite math on clamped
    operands."""
    big = 37.5  # beyond ndtr resolution in float64
    hc = torch.clamp(h, -big, big)
    kc = torch.clamp(k, -big, big)
    out = _bvnu_finite(hc, kc, r)
    out = torch.where(h == -math.inf, ndtr(-kc), out)
    out = torch.where(k == -math.inf, ndtr(-hc), out)
    out = torch.where((h == -math.inf) & (k == -math.inf), 1.0, out)
    return torch.where((h == math.inf) | (k == math.inf), 0.0, out)


class _BVNU(torch.autograd.Function):
    """P(X > h, Y > k) on broadcast operands, with the exact derivatives

        d/dh = -phi(h) Phi((r h - k)/sqrt(1-r^2))
        d/dk = -phi(k) Phi((r k - h)/sqrt(1-r^2))
        d/dr = phi_2(h, k; r)   (the bivariate normal density)

    bounded by construction: r is clamped away from +/-1 and the density's
    quadratic form at >= 0 (exact for |r| <= 1). Without the clamps a
    correlation rounded to 1 + eps, which a saturated float32 policy squash
    produces, overflows exp(-quad) and turns the clipped gradient to NaN."""

    @staticmethod
    def forward(ctx, h, k, r):
        ctx.save_for_backward(h, k, r)
        return _bvnu_value(h, k, r)

    @staticmethod
    def backward(ctx, g):
        h, k, r = ctx.saved_tensors
        eps = 1e-12 if h.dtype == torch.float64 else 1e-6
        rc = torch.clamp(r, eps - 1.0, 1.0 - eps)
        s2 = 1.0 - rc * rc
        inv_s = torch.rsqrt(s2)
        inv_sqrt2pi = 1.0 / math.sqrt(_2PI)
        d_dh = -inv_sqrt2pi * torch.exp(-0.5 * h * h) * ndtr((rc * h - k) * inv_s)
        d_dk = -inv_sqrt2pi * torch.exp(-0.5 * k * k) * ndtr((rc * k - h) * inv_s)
        quad = torch.clamp(h * h - 2.0 * rc * h * k + k * k, min=0.0) / (2.0 * s2)
        d_dr = torch.exp(-quad) * inv_s / _2PI
        return g * d_dh, g * d_dk, g * d_dr


def bvnu(h, k, r) -> torch.Tensor:
    """Upper-right bivariate normal probability P(X > h, Y > k)."""
    return _BVNU.apply(*torch.broadcast_tensors(h, k, r))



def bvn(xl, xu, yl, yu, r) -> torch.Tensor:
    """Rectangle probability P(xl < X < xu, yl < Y < yu), clipped to [0, 1]."""
    p = bvnu(xl, yl, r) - bvnu(xu, yl, r) - bvnu(xl, yu, r) + bvnu(xu, yu, r)
    return torch.clamp(p, 0.0, 1.0)


def bvn_cdf(h, k, r) -> torch.Tensor:
    """Lower-left CDF P(X <= h, Y <= k) = bvnu(-h, -k, r)."""
    return bvnu(-torch.as_tensor(h), -torch.as_tensor(k), r)
