"""The trigonometric-encoder moment match as one CUDA kernel op
(counterpart of gpflowpilco_tpu/ops/enc_match_pallas.py).

For x ~ N(mx, S), active dims a (in the given order) and inactive dims b
(the rest, ascending), y = [sin x_a; cos x_a; x_b] has De = 2|a| + |b| and

    y_mean (..., De), y_cov (..., De, De), cross = Cov(x, y) (..., D, De)

(not premultiplied), exactly ``Encoder(SinCos).moment_match``. The backward
is the hand adjoint of the JAX kernel (enc_match_pallas._enc_bwd_core).

Dispatch is by the device of the tensors: CUDA tensors go to the kernels of
``csrc/enc_match.cu`` (float32 or float64, contiguous, D <= 16, else the
wrapper raises), CPU tensors to ``enc_match_reference`` and
``enc_match_reference_bwd``. There is no fallback from one to the other.
``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..utils import tracing
from . import _build

# kernel launches per entry; reset with reset_launches()
launches = tracing.register_launches(
    {f"enc_match_{kind}_{sfx}": 0 for kind in ("fwd", "bwd") for sfx in ("f32", "f64")})

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
MAX_D = 16  # kMaxD in csrc/enc_match.cu: active dims travel as 4-bit fields


class EncMeta(NamedTuple):
    num_dim: int  # D
    active: Tuple[int, ...]  # active dim indices, in order
    inactive: Tuple[int, ...]  # the rest, ascending

    @property
    def num_out(self) -> int:
        return 2 * len(self.active) + len(self.inactive)


def make_enc_meta(active_dims, num_dim: int) -> EncMeta:
    active = tuple(int(i) for i in active_dims)
    if len(set(active)) != len(active) or not active or not all(0 <= i < num_dim for i in active):
        raise ValueError(f"active dims {active} of a {num_dim}-dim state")
    inactive = tuple(i for i in range(num_dim) if i not in set(active))
    return EncMeta(num_dim=num_dim, active=active, inactive=inactive)


def operand_check(name: str, meta: EncMeta, vecs=(), mats=(), others=()):
    """Raise ValueError unless the (N, D) vectors, (N, D, D) matrices and
    (tensor, shape) ``others`` have the meta's shapes with D <= 16, and
    TypeError unless all share one float32 or float64 dtype."""
    d = meta.num_dim
    n = (vecs or mats)[0].shape[0]
    want = [(t, (n, d)) for t in vecs] + [(t, (n, d, d)) for t in mats] + list(others)
    for t, shape in want:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, expected {tuple(shape)}")
    if d > MAX_D:
        raise ValueError(f"{name}: the kernels take D <= {MAX_D}, got D={d}")
    dtypes = {t.dtype for t, _ in want}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _SUFFIX:
        raise TypeError(f"{name}: operands must share float32 or float64, got {dtypes}")
    return n


def reset_launches():
    for k in launches:
        launches[k] = 0


# ----------------------------------------------------------------- plain torch
@functools.lru_cache(maxsize=None)
def _index(meta: EncMeta, device):
    """Active and inactive index tensors, made once per meta and device."""
    a = torch.tensor(meta.active, dtype=torch.long, device=device)
    b = torch.tensor(meta.inactive, dtype=torch.long, device=device)
    return a, b


def _terms(meta, mx, sxx):
    a, _ = _index(meta, mx.device)
    m = mx[:, a]
    saa = sxx[:, a][:, :, a]
    v = torch.clamp(torch.diagonal(saa, dim1=-2, dim2=-1), min=0.0)
    ev = torch.exp(-0.5 * v)
    s1, c1 = ev * torch.sin(m), ev * torch.cos(m)
    vv = v[:, :, None] + v[:, None, :]
    cross_s = saa + saa.mT
    pa = torch.exp(-0.5 * (vv + cross_s))
    pb = torch.exp(-0.5 * (vv - cross_s))
    madd = m[:, :, None] + m[:, None, :]
    msub = m[:, :, None] - m[:, None, :]
    return dict(m=m, v=v, ev=ev, s1=s1, c1=c1, a=pa, b=pb, madd=madd, msub=msub)


def enc_match_reference(meta: EncMeta, mx, sxx):
    """Plain torch (y_mean (N, De), y_cov (N, De, De), cross (N, D, De))."""
    a_idx, b_idx = _index(meta, mx.device)
    t = _terms(meta, mx, sxx)
    pa, pb, madd, msub = t["a"], t["b"], t["madd"], t["msub"]
    ss = 0.5 * (pb * torch.cos(msub) - pa * torch.cos(madd))
    cc = 0.5 * (pb * torch.cos(msub) + pa * torch.cos(madd))
    sc = 0.5 * (pb * torch.sin(msub) + pa * torch.sin(madd))
    y1 = torch.cat([t["s1"], t["c1"]], dim=-1)
    raw2 = torch.cat([torch.cat([ss, sc], -1), torch.cat([sc.mT, cc], -1)], -2)
    ytt = raw2 - y1[:, :, None] * y1[:, None, :]
    sxa = sxx[:, :, a_idx]
    sxy_t = torch.cat([sxa * t["c1"][:, None, :], sxa * (-t["s1"])[:, None, :]], dim=-1)
    if not meta.inactive:
        return y1, ytt, sxy_t
    sby = sxy_t[:, b_idx]
    sxb = sxx[:, :, b_idx]
    y_cov = torch.cat([torch.cat([ytt, sby.mT], -1), torch.cat([sby, sxb[:, b_idx]], -1)], -2)
    return torch.cat([y1, mx[:, b_idx]], -1), y_cov, torch.cat([sxy_t, sxb], -1)


def enc_match_reference_bwd(meta: EncMeta, mx, sxx, dym, dyc, dcr):
    """Plain torch hand adjoint (dmx (N, D), dsxx (N, D, D)), the formulas
    of enc_match_pallas._enc_bwd_core."""
    a_idx, b_idx = _index(meta, mx.device)
    na, nt = len(meta.active), 2 * len(meta.active)
    t = _terms(meta, mx, sxx)
    s1, c1, ev, m = t["s1"], t["c1"], t["ev"], t["m"]
    dm = torch.zeros_like(mx)
    ds = torch.zeros_like(sxx)
    if meta.inactive:
        dm[:, b_idx] += dym[:, nt:]
        ds[:, b_idx[:, None], b_idx[None, :]] += dyc[:, nt:, nt:]
        ds[:, :, b_idx] += dcr[:, :, nt:]

    y1 = torch.cat([s1, c1], dim=-1)
    dtt = dyc[:, :nt, :nt]
    dy1 = dym[:, :nt] - ((dtt + dtt.mT) @ y1[:, :, None])[..., 0]
    dsxy = dcr[:, :, :nt].clone()
    if meta.inactive:
        dsxy[:, b_idx] += dyc[:, nt:, :nt] + dyc[:, :nt, nt:].mT
    sxa = sxx[:, :, a_idx]
    ds[:, :, a_idx] += dsxy[:, :, :na] * c1[:, None, :] - dsxy[:, :, na:] * s1[:, None, :]
    dc1 = torch.sum(dsxy[:, :, :na] * sxa, dim=1) + dy1[:, na:]
    ds1 = -torch.sum(dsxy[:, :, na:] * sxa, dim=1) + dy1[:, :na]

    dss, dcc = dtt[:, :na, :na], dtt[:, na:, na:]
    dsc = dtt[:, :na, na:] + dtt[:, na:, :na].mT
    pa, pb, madd, msub = t["a"], t["b"], t["madd"], t["msub"]
    ca, sa, cb, sb = torch.cos(madd), torch.sin(madd), torch.cos(msub), torch.sin(msub)
    da = 0.5 * (-dss * ca + dcc * ca + dsc * sa)
    db = 0.5 * (dss * cb + dcc * cb + dsc * sb)
    dmadd = 0.5 * (dss * pa * sa - dcc * pa * sa + dsc * pa * ca)
    dmsub = 0.5 * (-dss * pb * sb - dcc * pb * sb + dsc * pb * cb)
    gab = -0.5 * da * pa - 0.5 * db * pb
    gmb = -0.5 * da * pa + 0.5 * db * pb
    dv = gab.sum(-1) + gab.sum(-2)
    ds[:, a_idx[:, None], a_idx[None, :]] += gmb + gmb.mT
    dma = (dmadd + dmsub).sum(-1) + (dmadd - dmsub).sum(-2)

    sm, cm = torch.sin(m), torch.cos(m)
    dev = ds1 * sm + dc1 * cm
    dma = dma + ds1 * ev * cm - dc1 * ev * sm
    dv = dv - 0.5 * dev * ev
    saa_diag = torch.diagonal(sxx[:, a_idx][:, :, a_idx], dim1=-2, dim2=-1)
    ds[:, a_idx, a_idx] += torch.where(saa_diag > 0, dv, torch.zeros_like(dv))
    dm[:, a_idx] += dma
    return dm, ds


# ----------------------------------------------------------------- dispatch
def _scalars(meta: EncMeta, n: int):
    packed = sum(a << (4 * i) for i, a in enumerate(meta.active))
    return (ctypes.c_int(n), ctypes.c_int(meta.num_dim), ctypes.c_int(len(meta.active)),
            ctypes.c_ulonglong(packed))


def _fwd(meta: EncMeta, mx, sxx):
    n = operand_check("enc_match_fwd", meta, (mx,), (sxx,))
    if mx.device.type == "cpu":
        return enc_match_reference(meta, mx, sxx)
    d, de = meta.num_dim, meta.num_out
    ym = torch.empty((n, de), dtype=mx.dtype, device=mx.device)
    yc = torch.empty((n, de, de), dtype=mx.dtype, device=mx.device)
    cr = torch.empty((n, d, de), dtype=mx.dtype, device=mx.device)
    name = f"enc_match_fwd_{_SUFFIX[mx.dtype]}"
    _build.launch("enc_match", name, (mx, sxx, ym, yc, cr), *_scalars(meta, n))
    launches[name] += 1
    return ym, yc, cr


def _bwd(meta: EncMeta, mx, sxx, dym, dyc, dcr):
    d, de = meta.num_dim, meta.num_out
    n = mx.shape[0]
    operand_check("enc_match_bwd", meta, (mx,), (sxx,),
                  ((dym, (n, de)), (dyc, (n, de, de)), (dcr, (n, d, de))))
    if mx.device.type == "cpu":
        return enc_match_reference_bwd(meta, mx, sxx, dym, dyc, dcr)
    dmx, dsxx = torch.empty_like(mx), torch.empty_like(sxx)
    name = f"enc_match_bwd_{_SUFFIX[mx.dtype]}"
    _build.launch("enc_match", name, (mx, sxx, dym, dyc, dcr, dmx, dsxx), *_scalars(meta, n))
    launches[name] += 1
    return dmx, dsxx


class FusedEncoderMatch(torch.autograd.Function):
    """(y_mean, y_cov, cross) from mx (N, D), sxx (N, D, D)."""

    @staticmethod
    def forward(ctx, mx, sxx, meta):
        ctx.meta = meta
        ctx.save_for_backward(mx, sxx)
        return _fwd(meta, mx, sxx)

    @staticmethod
    def backward(ctx, dym, dyc, dcr):
        mx, sxx = ctx.saved_tensors
        dmx, dsxx = _bwd(ctx.meta, mx, sxx, dym.contiguous(), dyc.contiguous(), dcr.contiguous())
        return dmx, dsxx, None


def fused_encoder_match(meta: EncMeta, mx, sxx):
    """mx (..., D), sxx (..., D, D) -> (y_mean (..., De), y_cov (..., De, De),
    cross (..., D, De)), matching Encoder(SinCos).moment_match exactly."""
    d, de = meta.num_dim, meta.num_out
    batch = mx.shape[:-1]
    ym, yc, cr = FusedEncoderMatch.apply(
        mx.reshape(-1, d).contiguous(), sxx.reshape(-1, d, d).contiguous(), meta
    )
    return ym.reshape(batch + (de,)), yc.reshape(batch + (de, de)), cr.reshape(batch + (d, de))
