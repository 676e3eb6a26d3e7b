"""The whole GPR moment match as one CUDA kernel op, K3g (counterpart of the
GPR half of gpflowpilco_tpu/ops/mm_match_pallas.py).

For x ~ N(mx, S) and an exact GPR (the training inputs X as the inducing
points, one kernel shared by the R output columns), everything between the
input moments and

    f1    (..., R)     = E[f] - mean_const
    sff   (..., R, R)  = Cov[f]  (with the model's uncertainty when asked)
    cross (..., D, R)  = S^{-1} Cov(x, f)   (premultiplied)

runs as one op: two D x D Cholesky factors (S + Lam for eKfu, S + V for the
symmetric (X, X) pair), the solves, eKfu, and E = exp(cexp - M) (N x N,
never stored) contracted into f2 = alpha^T E alpha and ecov = sum(Kyy^{-1}
o E). The backward is frozen: cotangents for (mx, sxx) only, since a GPR's
hyperparameters train through its LML or HMC and never through the match.

The grid carries a member axis K (K = 1 for one GPR): the moments come as
(B, K, D) and entry (b, k) reads member k, so one launch matches every
member of an ensemble against its own state. The grid
(``build_fused_gpr_match_grid``) is plain torch, built once per model by
the match cache; it is not padded.

Dispatch is by the device of the tensors: CUDA tensors go to the kernels of
``csrc/gpr_match.cu`` (float32 or float64, contiguous, D <= 16, R <= 4, any
N, else the wrapper raises), CPU tensors to ``gpr_match_reference`` and
``gpr_match_reference_bwd``. There is no fallback from one to the other.
``launches`` counts kernel launches only (a call of the tiles and the
combine counts once). Both entries cut each member's N x N grid into
TILE x TILE tiles on the block grid. The wrapper allocates the scratch of
partial sums: the forward's, per (entry, member), one slot per eKfu block
of _LATENT points and one per tile; the backward's, one slot per block of
_ROWS points of its finish, and the tiles' row partials, (B, K,
ceil(N / TILE), D + 2, N) values.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from typing import NamedTuple

import torch

from ..utils import tracing
from . import _build
from .kexp_cuda import gpr_pair_factors
from .linalg import bsolve_triangular, cholesky_nan

# kernel launches per entry; reset with reset_launches()
launches = tracing.register_launches(
    {f"gpr_match_{kind}_{sfx}": 0 for kind in ("fwd", "bwd_frozen") for sfx in ("f32", "f64")})

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
MAX_D, MAX_R = 16, 4  # csrc/gpr_match.cu's kMaxD and kMaxR
_ROWS = 128  # points per block of the backward's finish (kThreads)
TILE = 64  # the tile side of both entries (kT): ceil(N / TILE)^2 tiles per member
_LATENT = 256  # points per eKfu block of the forward (kTileThreads)


def reset_launches():
    for k in launches:
        launches[k] = 0


class GPRMatchMeta(NamedTuple):
    num_out: int  # R
    num_dim: int  # D
    num_n: int  # N training points
    num_members: int  # K (1 for one GPR)
    uncertainty: bool  # include the expected-covariance (model uncertainty) term


@dataclass(frozen=True)
class FusedGPRMatchGrid:
    """The state-independent tensors of the GPR match (cf. GPRMatchCache),
    with the member axis K in front."""

    kdiag: torch.Tensor  # (K, 2, D): lam, vdiag
    xt: torch.Tensor  # (D, N) training inputs, transposed (shared)
    alpha: torch.Tensor  # (K, N, R) representer weights
    varr: torch.Tensor  # (K,) kernel variance
    hll: torch.Tensor  # (K,) 0.5 sum log lam
    kyy_inv: torch.Tensor  # (K, N, N), symmetrized
    ut: torch.Tensor  # (K, D, N) pair centre factor (u = w = X/2)
    g1t: torch.Tensor  # (K, D, N)
    g11: torch.Tensor  # (K, N)
    cp: torch.Tensor  # (K,) log v^2 + 0.5 sum log vdiag
    meta: GPRMatchMeta = None

    def tensors(self):
        return tuple(getattr(self, f) for f in GPR_GRID_FIELDS)


GPR_GRID_FIELDS = tuple(f.name for f in fields(FusedGPRMatchGrid) if f.name != "meta")


def build_fused_gpr_match_grid(model, alpha, kyy_inv, uncertainty: bool = True) -> FusedGPRMatchGrid:
    """model: a GPR, stacked or not; alpha (..., N, R) and kyy_inv (..., N, N)
    from its match cache. Detached: the match is frozen."""
    lift = (lambda a: a.detach()) if model.stacked else (lambda a: a.detach()[None])  # noqa: E731
    var, ls = lift(model.kernel.variance), lift(model.kernel.lengthscales)
    alpha, kyy_inv = lift(alpha), lift(kyy_inv)
    xdata = model.x.detach()
    num_n, d = xdata.shape
    lam = ls * ls  # (K, D)
    vdiag, ut, g1t, g11, cp = gpr_pair_factors(var, ls, xdata)
    meta = GPRMatchMeta(
        num_out=alpha.shape[-1], num_dim=d, num_n=num_n, num_members=var.shape[0],
        uncertainty=bool(uncertainty),
    )
    return FusedGPRMatchGrid(
        kdiag=torch.stack([lam, vdiag], dim=1).contiguous(),
        xt=xdata.mT.contiguous(),
        alpha=alpha.contiguous(),
        varr=var.contiguous(),
        hll=0.5 * torch.sum(torch.log(lam), -1),
        # symmetric: the backward reads Kyy^{-1}[i, j] for [j, i] too
        kyy_inv=(0.5 * (kyy_inv + kyy_inv.mT)).contiguous(),
        ut=ut, g1t=g1t, g11=g11, cp=cp,
        meta=meta,
    )


# ----------------------------------------------------------------- plain torch
def _solve(ch, b, trans=0):
    return bsolve_triangular(ch, b, lower=True, trans=trans)


def gpr_match_reference(meta: GPRMatchMeta, g: FusedGPRMatchGrid, mx, sxx):
    """Plain torch: mx (B, K, D), sxx (B, K, D, D) -> f1 (B, K, R),
    sff (B, K, R, R), cross (B, K, D, R)."""
    ch = cholesky_nan(sxx[:, :, None] + torch.diag_embed(g.kdiag))  # (B, K, 2, D, D)
    hls = torch.sum(torch.log(torch.diagonal(ch, dim1=-2, dim2=-1)), -1)  # (B, K, 2)
    ch0, ch1 = ch[:, :, 0], ch[:, :, 1]
    y = _solve(ch0, g.xt - mx[..., None])  # (B, K, D, N)
    quad = torch.sum(y * y, -2)
    e = g.varr[:, None] * torch.exp((g.hll - hls[..., 0])[..., None] - 0.5 * quad)  # (B, K, N)
    iv = _solve(ch0, y, trans=1)
    ae = e[..., None] * g.alpha  # (B, K, N, R)
    f1 = torch.sum(ae, -2)
    cross = iv @ ae  # (B, K, D, R)

    up = _solve(ch1, g.ut) - 0.5 * _solve(ch1, mx[..., None])  # (B, K, D, N)
    a_u = g.g11 + torch.sum(up * up, -2)
    cexp = g.cp - hls[..., 1]
    m_p = -(g.g1t.mT @ g.g1t) + up.mT @ up + 0.5 * a_u[..., :, None] + 0.5 * a_u[..., None, :]
    ep = torch.exp(cexp[..., None, None] - m_p)  # (B, K, N, N)
    sff = g.alpha.mT @ ep @ g.alpha - f1[..., :, None] * f1[..., None, :]
    if meta.uncertainty:
        ecov = torch.sum(g.kyy_inv * ep, dim=(-2, -1))
        eye = torch.eye(meta.num_out, dtype=mx.dtype, device=mx.device)
        sff = sff + eye * (g.varr - ecov)[..., None, None]
    return f1, sff, cross


def gpr_match_reference_bwd(meta: GPRMatchMeta, g: FusedGPRMatchGrid, mx, sxx, df1, dsff, dcross):
    """Plain torch frozen backward, by autograd through the plain forward:
    (dmx (B, K, D), dsxx (B, K, D, D) symmetric)."""
    with torch.enable_grad():
        m = mx.detach().requires_grad_(True)
        s = sxx.detach().requires_grad_(True)
        outs = gpr_match_reference(meta, g, m, s)
        dmx, dsxx = torch.autograd.grad(outs, (m, s), (df1, dsff, dcross))
    return dmx, 0.5 * (dsxx + dsxx.mT)


# ----------------------------------------------------------------- dispatch
def scratch_values(d: int, n: int, backward: bool) -> int:
    """Partial sums per (entry, member) (csrc/gpr_match.cu nv_fwd_*, nv_bwd)
    at the register capacity of D: the forward's eKfu slots and tile slots,
    or the backward finish's slots."""
    dm = 8 if d <= 8 else 16
    if backward:
        return -(-n // _ROWS) * 2 * (dm * (dm + 1) // 2 + dm + 1)
    return -(-n // _LATENT) * (MAX_R + dm * MAX_R) + (-(-n // TILE)) ** 2 * (MAX_R * MAX_R + 1)


def operand_check(name: str, meta: GPRMatchMeta, g: FusedGPRMatchGrid, mx, sxx, cots=()):
    """Raise ValueError unless every operand has the shape the kernels index
    it by, D <= 16 and R <= 4, and TypeError unless all share one float32 or
    float64 dtype. N has no limit: the kernels cut the grid into tiles."""
    r, d, n, k = meta.num_out, meta.num_dim, meta.num_n, meta.num_members
    b = mx.shape[0]
    shapes = dict(kdiag=(k, 2, d), xt=(d, n), alpha=(k, n, r), varr=(k,), hll=(k,),
                  kyy_inv=(k, n, n), ut=(k, d, n), g1t=(k, d, n), g11=(k, n), cp=(k,))
    want = [("mx", mx, (b, k, d)), ("sxx", sxx, (b, k, d, d))]
    want += [(f, getattr(g, f), shapes[f]) for f in GPR_GRID_FIELDS]
    want += [(f"cotangent {i}", t, s) for i, (t, s) in enumerate(cots)]
    for what, t, shape in want:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if d > MAX_D or r > MAX_R:
        raise ValueError(f"{name}: the kernels take D <= {MAX_D} and R <= {MAX_R}, got D={d}, R={r}")
    dtypes = {t.dtype for _, t, _ in want}
    if len(dtypes) != 1 or mx.dtype not in _SUFFIX:
        raise TypeError(f"{name}: operands must share float32 or float64, got {dtypes}")
    return b


def _ints(meta: GPRMatchMeta, b: int):
    return tuple(ctypes.c_int(v) for v in (b, meta.num_members, meta.num_dim, meta.num_n,
                                           meta.num_out, int(meta.uncertainty)))


def _scratch(meta: GPRMatchMeta, b: int, backward: bool, like):
    nv = scratch_values(meta.num_dim, meta.num_n, backward)
    return torch.empty((b, meta.num_members, nv), dtype=like.dtype, device=like.device)


def _fwd(meta: GPRMatchMeta, g: FusedGPRMatchGrid, mx, sxx):
    b = operand_check("gpr_match_fwd", meta, g, mx, sxx)
    if mx.device.type == "cpu":
        return gpr_match_reference(meta, g, mx, sxx)
    r, d, k = meta.num_out, meta.num_dim, meta.num_members
    new = lambda *shape: torch.empty(shape, dtype=mx.dtype, device=mx.device)  # noqa: E731
    f1, sff, cross = new(b, k, r), new(b, k, r, r), new(b, k, d, r)
    name = f"gpr_match_fwd_{_SUFFIX[mx.dtype]}"
    _build.launch("gpr_match", name, (mx, sxx, *g.tensors(), f1, sff, cross,
                                      _scratch(meta, b, False, mx)), *_ints(meta, b))
    launches[name] += 1
    return f1, sff, cross


def _bwd(meta: GPRMatchMeta, g: FusedGPRMatchGrid, mx, sxx, f1, df1, dsff, dcross):
    r, d, k = meta.num_out, meta.num_dim, meta.num_members
    b = mx.shape[0]
    operand_check("gpr_match_bwd", meta, g, mx, sxx,
                  ((f1, (b, k, r)), (df1, (b, k, r)), (dsff, (b, k, r, r)), (dcross, (b, k, d, r))))
    if mx.device.type == "cpu":
        return gpr_match_reference_bwd(meta, g, mx, sxx, df1, dsff, dcross)
    dmx, dsxx = torch.empty_like(mx), torch.empty_like(sxx)
    # each row's D + 2 partial sums over each column tile of E
    rp = torch.empty((b, k, -(-meta.num_n // TILE), d + 2, meta.num_n), dtype=mx.dtype,
                     device=mx.device)
    name = f"gpr_match_bwd_frozen_{_SUFFIX[mx.dtype]}"
    _build.launch("gpr_match", name, (mx, sxx, *g.tensors(), f1, df1, dsff, dcross, dmx, dsxx,
                                      _scratch(meta, b, True, mx), rp), *_ints(meta, b))
    launches[name] += 1
    return dmx, dsxx


class FusedGPRMatch(torch.autograd.Function):
    """(f1, sff, cross) from mx (B, K, D), sxx (B, K, D, D) and the grid's
    tensors; the backward gives (mx, sxx) cotangents only and None for
    every grid tensor."""

    @staticmethod
    def forward(ctx, mx, sxx, meta, *grid):
        g = FusedGPRMatchGrid(**dict(zip(GPR_GRID_FIELDS, grid)), meta=meta)
        f1, sff, cross = _fwd(meta, g, mx, sxx)
        ctx.meta = meta
        ctx.save_for_backward(mx, sxx, f1, *grid)
        return f1, sff, cross

    @staticmethod
    def backward(ctx, df1, dsff, dcross):
        mx, sxx, f1, *grid = ctx.saved_tensors
        g = FusedGPRMatchGrid(**dict(zip(GPR_GRID_FIELDS, grid)), meta=ctx.meta)
        dmx, dsxx = _bwd(ctx.meta, g, mx, sxx, f1, df1.contiguous(), dsff.contiguous(),
                         dcross.contiguous())
        return (dmx, dsxx, None, *(None,) * len(GPR_GRID_FIELDS))


def fused_gpr_match(grid: FusedGPRMatchGrid, mx, sxx):
    """Whole GPR match op, frozen: mx (..., D), sxx (..., D, D) ->
    (f1 (..., R), sff (..., R, R), cross (..., D, R)), without the mean
    constant. For a stacked grid the moments' last batch axis is the member
    axis."""
    meta = grid.meta
    d, r, k = meta.num_dim, meta.num_out, meta.num_members
    batch = mx.shape[:-1]
    f1, sff, cross = FusedGPRMatch.apply(
        mx.reshape(-1, k, d).contiguous(), sxx.reshape(-1, k, d, d).contiguous(), meta,
        *grid.tensors(),
    )
    return (f1.reshape(batch + (r,)), sff.reshape(batch + (r, r)), cross.reshape(batch + (d, r)))
