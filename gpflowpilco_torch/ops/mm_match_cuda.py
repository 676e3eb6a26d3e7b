"""The whole SVGP moment match as one CUDA kernel op (counterpart of the SVGP
half of gpflowpilco_tpu/ops/mm_match_pallas.py).

For x ~ N(mx, S) and a latent-stacked SVGP, everything between the input
moments and the match's outputs

    f1    (..., L)     = E[f]
    sff   (..., L, L)  = Cov[f]  (with the model's uncertainty when asked)
    cross (..., D, L)  = S^{-1} Cov(x, f)   (premultiplied)

runs as one op: the D x D Cholesky factors of the K = L + P matrices
S + diag(kdiag_k) (L latents, P = L(L+1)/2 latent pairs), the solves, eKfu,
and per pair E_p = exp(cexp_p - M_p) (M x M, never stored) contracted into
f2_p = alpha_u^T E_p alpha_w and ecov_l = sum(Q_l o E_ll). The backward is
the hand adjoint of the JAX kernel (mm_match_pallas._bwd_core): ``frozen``
gives cotangents for (mx, sxx) only (the drift inside a policy update), the
full one also for every grid tensor, through which they reach the model.

The grid (``build_fused_match_grid``) is plain differentiable torch, built
once per model by the match cache. Unlike the TPU's, it is not padded: M
and D keep their sizes and the kernel masks ragged edges itself.

Dispatch is by the device of the tensors: CUDA tensors go to the kernels of
``csrc/mm_match.cu`` (float32 or float64, contiguous, D <= 16, else the
wrapper raises), CPU tensors to ``match_reference`` and
``match_reference_bwd``. There is no fallback from one to the other.
``launches`` counts kernel launches only, one per entry call. The forward
and the frozen backward cut each pair's M x M grid into tiles on the block
grid; the wrapper allocates their tile partials (``tile_count``). The full
backward runs a block per group and batch entry; with a batch of N > 1 the
wrapper allocates N slots of the grid cotangents (N x 0.30 M values at the
drift's shape), which the kernel adds in batch order.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields
from typing import NamedTuple, Tuple

import torch

from ..utils import tracing
from . import _build, kexp
from .linalg import bsolve_triangular, cholesky_nan

# kernel launches per entry; reset with reset_launches()
launches = tracing.register_launches({
    f"svgp_match_{kind}_{sfx}": 0
    for kind in ("fwd", "bwd_frozen", "bwd")
    for sfx in ("f32", "f64")
})

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
MAX_D = 16  # csrc/mm_match.cu's largest register capacity
MAX_SHARED_BYTES = 232448 - 20480  # a block's 227 KB less the kernel's static shared memory
TILE = 64  # csrc/mm_match.cu's tile side (kTI, kTJ) in the forward and the frozen backward


def reset_launches():
    for k in launches:
        launches[k] = 0


class MatchMeta(NamedTuple):
    num_latent: int  # L
    num_pairs: int  # P = L(L+1)/2
    num_dim: int  # D
    num_m: int  # M
    uncertainty: bool  # include the expected-covariance (model uncertainty) term
    pairs: Tuple[Tuple[int, int], ...]  # upper-triangular latent pairs, in grid order


@dataclass(frozen=True)
class FusedMatchGrid:
    """The state-independent tensors of the SVGP match, built once per model
    (cf. SVGPMatchCache). K = L + P groups; not padded."""

    kdiag: torch.Tensor  # (K, D) diag additions: lam_l rows, then vdiag_p rows
    zt: torch.Tensor  # (L, D, M) inducing points, transposed
    alpha: torch.Tensor  # (L, M) representer weights
    varr: torch.Tensor  # (L,) kernel variances
    hll: torch.Tensor  # (L,) 0.5 sum log lam_l
    qmat: torch.Tensor  # (L, M, M) Kuu^{-1} - Luu^{-T} CC^T Luu^{-1}
    ut: torch.Tensor  # (P, D, M) pair centre factors u^T
    wt: torch.Tensor  # (P, D, M)
    g1t: torch.Tensor  # (P, D, M) x-free Gaussian factors
    g2t: torch.Tensor  # (P, D, M)
    g11: torch.Tensor  # (P, M)
    g22: torch.Tensor  # (P, M)
    cp: torch.Tensor  # (P,) log(v_i v_j) + 0.5 sum log vdiag
    alpha_u: torch.Tensor  # (P, M) alpha[i(p)]
    alpha_w: torch.Tensor  # (P, M) alpha[j(p)]
    meta: MatchMeta = None

    def tensors(self):
        return tuple(getattr(self, f) for f in GRID_FIELDS)


GRID_FIELDS = tuple(f.name for f in fields(FusedMatchGrid) if f.name != "meta")


def build_fused_match_grid(model, alpha, qmat, uncertainty: bool = True) -> FusedMatchGrid:
    """model: a latent-stacked SVGP; alpha (L, M) and qmat (L, M, M) from its
    match cache. Differentiable in the model's parameters."""
    z = model.z  # (L, M, D)
    num_latent, num_m, d = z.shape
    var, ls = model.kernel.variance, model.kernel.lengthscales
    lam = kexp.latent_lam(model.kernel, d)  # (L, D)
    pairs = tuple(kexp.latent_pairs(num_latent))
    i_idx, j_idx = _latent_index(num_latent, z.device)
    vdiag, u, w, _ = kexp.ekzxxz_pair_terms(
        var[i_idx], ls[i_idx], z[i_idx], var[j_idx], ls[j_idx], z[j_idx]
    )
    lam_i = kexp._bc_lengthscales(ls[i_idx], d) ** 2
    lam_j = kexp._bc_lengthscales(ls[j_idx], d) ** 2
    inv_sqrt = torch.sqrt(1.0 / (lam_i + lam_j))[:, None, :]
    g1 = z[i_idx] * inv_sqrt  # (P, M, D)
    g2 = z[j_idx] * inv_sqrt
    meta = MatchMeta(
        num_latent=num_latent, num_pairs=len(pairs), num_dim=d, num_m=num_m,
        uncertainty=bool(uncertainty), pairs=pairs,
    )
    return FusedMatchGrid(
        kdiag=torch.cat([lam, vdiag], dim=0),
        zt=z.mT.contiguous(),
        alpha=alpha.contiguous(),
        varr=var.contiguous(),
        hll=0.5 * torch.sum(torch.log(lam), -1),
        qmat=qmat.contiguous(),
        ut=u.mT.contiguous(),
        wt=w.mT.contiguous(),
        g1t=g1.mT.contiguous(),
        g2t=g2.mT.contiguous(),
        g11=torch.sum(g1 * g1, -1),
        g22=torch.sum(g2 * g2, -1),
        cp=torch.log(var[i_idx] * var[j_idx]) + 0.5 * torch.sum(torch.log(vdiag), -1),
        alpha_u=alpha[i_idx].contiguous(),
        alpha_w=alpha[j_idx].contiguous(),
        meta=meta,
    )


@functools.lru_cache(maxsize=None)
def _latent_index(num_latent: int, device):
    """(i, j) latent index tensors of the pairs, made once per device: an
    index built from a host list is a copy that waits for the device."""
    pairs = kexp.latent_pairs(num_latent)
    return (torch.tensor([p[0] for p in pairs], device=device),
            torch.tensor([p[1] for p in pairs], device=device))


@functools.lru_cache(maxsize=None)
def _pair_index(meta: MatchMeta, device):
    """Pair rows and columns, the diagonal pairs and the (L, L) pair lookup,
    made once per meta and device."""
    pi = torch.tensor([p[0] for p in meta.pairs], device=device)
    pj = torch.tensor([p[1] for p in meta.pairs], device=device)
    lut = {p: k for k, p in enumerate(meta.pairs)}
    diag_pos = torch.tensor([lut[(l, l)] for l in range(meta.num_latent)], device=device)
    full = torch.tensor(
        [[lut[(min(i, j), max(i, j))] for j in range(meta.num_latent)]
         for i in range(meta.num_latent)], device=device,
    )
    return pi, pj, diag_pos, full


# ----------------------------------------------------------------- plain torch
def _solve(ch, b, trans=0):
    return bsolve_triangular(ch, b, lower=True, trans=trans)


def _forward_parts(meta: MatchMeta, g: FusedMatchGrid, mx, sxx):
    """Every intermediate of the forward, batched over N."""
    num_latent = meta.num_latent
    _, _, diag_pos, full = _pair_index(meta, mx.device)
    ch = cholesky_nan(sxx[:, None] + torch.diag_embed(g.kdiag))  # (N, K, D, D)
    hls = torch.sum(torch.log(torch.diagonal(ch, dim1=-2, dim2=-1)), -1)  # (N, K)
    ch_l, ch_p = ch[:, :num_latent], ch[:, num_latent:]
    hls_l, hls_p = hls[:, :num_latent], hls[:, num_latent:]

    y = _solve(ch_l, g.zt - mx[:, None, :, None])  # (N, L, D, M)
    quad = torch.sum(y * y, -2)
    e = g.varr[:, None] * torch.exp((g.hll - hls_l)[..., None] - 0.5 * quad)  # (N, L, M)
    iv = _solve(ch_l, y, trans=1)
    ae = g.alpha * e
    f1 = torch.sum(ae, -1)  # (N, L)
    cross = torch.sum(iv * ae[:, :, None, :], -1).mT  # (N, D, L)

    ilu = _solve(ch_p, g.ut)  # (N, P, D, M)
    ilw = _solve(ch_p, g.wt)
    ilm = _solve(ch_p, mx[:, None, :, None])  # (N, P, D, 1)
    up, wp = ilu - 0.5 * ilm, ilw - 0.5 * ilm
    a_u = g.g11 + torch.sum(up * up, -2)  # (N, P, M)
    a_w = g.g22 + torch.sum(wp * wp, -2)
    cexp = g.cp - hls_p  # (N, P)
    m_p = -(g.g1t.mT @ g.g2t) + up.mT @ wp + 0.5 * a_u[..., :, None] + 0.5 * a_w[..., None, :]
    ep = torch.exp(cexp[..., None, None] - m_p)  # (N, P, M, M)
    f2p = torch.sum((g.alpha_u[:, None, :] @ ep)[..., 0, :] * g.alpha_w, -1)  # (N, P)
    sff = f2p[:, full] - f1[:, :, None] * f1[:, None, :]
    if meta.uncertainty:
        ecov = torch.sum(g.qmat * ep[:, diag_pos], dim=(-2, -1))  # (N, L)
        sff = sff + torch.diag_embed(g.varr - ecov)
    return dict(ch=ch, ch_l=ch_l, ch_p=ch_p, y=y, e=e, iv=iv, ae=ae, f1=f1, sff=sff,
                cross=cross, ilu=ilu, ilw=ilw, ilm=ilm, up=up, wp=wp, ep=ep)


def match_reference(meta: MatchMeta, g: FusedMatchGrid, mx, sxx):
    """Plain torch (f1 (N, L), sff (N, L, L), cross (N, D, L))."""
    p = _forward_parts(meta, g, mx, sxx)
    return p["f1"], p["sff"], p["cross"]


def chol_rev(ch, dch):
    """Adjoint of the unrolled Cholesky recurrence (mm_match_pallas._chol_rev),
    batched: ch and dch (..., D, D), lower; returns the lower-triangle
    cotangent of the factored matrix."""
    d = ch.shape[-1]
    dl = dch.clone()
    da = torch.zeros_like(ch)
    for j in reversed(range(d)):
        inv = 1.0 / ch[..., j, j]
        for i in reversed(range(j + 1, d)):
            gi = dl[..., i, j] * inv
            da[..., i, j] += gi
            dl[..., j, j] -= gi * ch[..., i, j]
            dl[..., i, :j] -= gi[..., None] * ch[..., j, :j]
            dl[..., j, :j] -= gi[..., None] * ch[..., i, :j]
        s = 0.5 * dl[..., j, j] * inv
        da[..., j, j] += s
        dl[..., j, :j] -= 2.0 * s[..., None] * ch[..., j, :j]
    return da


def match_reference_bwd(meta: MatchMeta, g: FusedMatchGrid, mx, sxx, df1_in, dsff, dcross,
                        frozen: bool):
    """Plain torch hand adjoint: (dmx (N, D), dsxx (N, D, D), grid cotangents
    summed over N as a FusedMatchGrid, or None when ``frozen``)."""
    p = _forward_parts(meta, g, mx, sxx)
    pi, pj, diag_pos, _ = _pair_index(meta, mx.device)
    ch, ch_l, ch_p, f1 = p["ch"], p["ch_l"], p["ch_p"], p["f1"]
    y, e, iv, ae, ep = p["y"], p["e"], p["iv"], p["ae"], p["ep"]

    df1 = df1_in - ((dsff + dsff.mT) @ f1[..., None])[..., 0]  # (N, L)
    ddiag = torch.diagonal(dsff, dim1=-2, dim2=-1)
    decov = -ddiag if meta.uncertainty else torch.zeros_like(ddiag)

    # latent part
    dcr = dcross.mT  # (N, L, D)
    dae = df1[..., None] + torch.sum(dcr[..., None] * iv, -2)  # (N, L, M)
    div = dcr[..., None] * ae[:, :, None, :]  # (N, L, D, M)
    de = g.alpha * dae
    ede = e * de
    s_ede = torch.sum(ede, -1)
    t_iv = _solve(ch_l, div)
    dy = 2.0 * y * (-0.5 * ede)[:, :, None, :] + t_iv
    dzc = _solve(ch_l, dy, trans=1)
    dch_l = -torch.tril(iv @ t_iv.mT) - torch.tril(dzc @ y.mT)
    dch_l = dch_l + torch.diag_embed(-s_ede[..., None] / torch.diagonal(ch_l, dim1=-2, dim2=-1))
    dmx = -torch.sum(dzc, dim=(1, 3))

    # pair part
    df2p = dsff[:, pi, pj] + torch.where(pi != pj, dsff[:, pj, pi], torch.zeros_like(dsff[:, pi, pj]))
    de_p = df2p[..., None, None] * (g.alpha_u[:, :, None] * g.alpha_w[:, None, :])
    qdec = torch.zeros_like(ep).index_add(1, diag_pos, decov[..., None, None] * g.qmat)
    de_p = de_p + qdec
    ede_p = ep * de_p
    s = torch.sum(ede_p, dim=(-2, -1))  # (N, P)
    da_u = -0.5 * torch.sum(ede_p, -1)  # (N, P, M)
    da_w = -0.5 * torch.sum(ede_p, -2)
    up, wp = p["up"], p["wp"]
    dup = -(wp @ ede_p.mT) + 2.0 * up * da_u[:, :, None, :]  # (N, P, D, M)
    dwp = -(up @ ede_p) + 2.0 * wp * da_w[:, :, None, :]
    dilm = -0.5 * (torch.sum(dup, -1) + torch.sum(dwp, -1))  # (N, P, D)
    tmp_u = _solve(ch_p, dup, trans=1)
    tmp_w = _solve(ch_p, dwp, trans=1)
    tmp_m = _solve(ch_p, dilm[..., None], trans=1)  # (N, P, D, 1)
    dch_p = -torch.tril(tmp_u @ p["ilu"].mT + tmp_w @ p["ilw"].mT + tmp_m @ p["ilm"].mT)
    dch_p = dch_p + torch.diag_embed(-s[..., None] / torch.diagonal(ch_p, dim1=-2, dim2=-1))
    dmx = dmx + torch.sum(tmp_m[..., 0], 1)

    da = chol_rev(ch, torch.cat([dch_l, dch_p], 1))  # (N, K, D, D) lower
    low = torch.sum(da, 1)
    dsxx = 0.5 * (low + low.mT)
    if frozen:
        return dmx, dsxx, None
    dvarr = torch.sum(de * e / g.varr[:, None], dim=(0, 2))
    if meta.uncertainty:
        dvarr = dvarr + torch.sum(ddiag, 0)
    dgrid = FusedMatchGrid(
        kdiag=torch.sum(torch.diagonal(da, dim1=-2, dim2=-1), 0),
        zt=torch.sum(dzc, 0),
        alpha=torch.sum(dae * e, 0),
        varr=dvarr,
        hll=torch.sum(s_ede, 0),
        qmat=torch.sum(decov[..., None, None] * ep[:, diag_pos], 0),
        ut=torch.sum(tmp_u, 0),
        wt=torch.sum(tmp_w, 0),
        g1t=torch.sum(g.g2t @ ede_p.mT, 0),
        g2t=torch.sum(g.g1t @ ede_p, 0),
        g11=torch.sum(da_u, 0),
        g22=torch.sum(da_w, 0),
        cp=torch.sum(s, 0),
        alpha_u=torch.sum(df2p[..., None] * (ep @ g.alpha_w[..., None])[..., 0], 0),
        alpha_w=torch.sum(df2p[..., None] * (g.alpha_u[:, None, :] @ ep)[..., 0, :], 0),
        meta=meta,
    )
    return dmx, dsxx, dgrid


# ----------------------------------------------------------------- dispatch
def shared_bytes(meta: MatchMeta, dtype, kind: str) -> int:
    """Dynamic shared memory of a pair block. The full backward (``"bwd"``)
    stages its group's (4D + 4) x M factors; a tile block of the forward
    (``"fwd"``) or the frozen backward (``"bwd_frozen"``) stages Q's tile and
    its rows' and columns' 2D + 2 factors, and the frozen backward adds its
    column partials per warp ((D + 1) x 8 x TILE)."""
    d, size = meta.num_dim, torch.finfo(dtype).bits // 8
    if kind == "bwd":
        return (4 * d + 4) * meta.num_m * size
    parts = (d + 1) * 8 * TILE if kind == "bwd_frozen" else 0
    return (TILE * TILE + (2 * d + 2) * 2 * TILE + parts) * size


def tile_count(meta: MatchMeta) -> int:
    """Tiles along one side of a pair's grid: ceil(M / TILE)."""
    return -(-meta.num_m // TILE)


def operand_check(name: str, kind: str, meta: MatchMeta, g: FusedMatchGrid, mx, sxx, cots=()):
    """Raise ValueError unless every operand has the shape the kernels index
    it by, D <= 16 and the entry ``kind``'s staged factors fit a block's
    shared memory, and TypeError unless all share one float32 or float64
    dtype."""
    num_l, num_p, d, m = meta.num_latent, meta.num_pairs, meta.num_dim, meta.num_m
    n = mx.shape[0]
    shapes = dict(
        kdiag=(num_l + num_p, d), zt=(num_l, d, m), alpha=(num_l, m), varr=(num_l,),
        hll=(num_l,), qmat=(num_l, m, m), ut=(num_p, d, m), wt=(num_p, d, m),
        g1t=(num_p, d, m), g2t=(num_p, d, m), g11=(num_p, m), g22=(num_p, m), cp=(num_p,),
        alpha_u=(num_p, m), alpha_w=(num_p, m),
    )
    want = [("mx", mx, (n, d)), ("sxx", sxx, (n, d, d))]
    want += [(f, getattr(g, f), shapes[f]) for f in GRID_FIELDS]
    want += [(f"cotangent {i}", t, s) for i, (t, s) in enumerate(cots)]
    for what, t, shape in want:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if d > MAX_D:
        raise ValueError(f"{name}: the kernels take D <= {MAX_D}, got D={d}")
    dtypes = {t.dtype for _, t, _ in want}
    if len(dtypes) != 1 or mx.dtype not in _SUFFIX:
        raise TypeError(f"{name}: operands must share float32 or float64, got {dtypes}")
    need = shared_bytes(meta, mx.dtype, kind)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: D={d}, M={m} need {need} bytes of shared memory, more than "
                         f"a block has")
    return n


def _ints(meta: MatchMeta, n: int):
    return (ctypes.c_int(n), ctypes.c_int(meta.num_latent), ctypes.c_int(meta.num_dim),
            ctypes.c_int(meta.num_m), ctypes.c_int(int(meta.uncertainty)))


def _fwd(meta: MatchMeta, g: FusedMatchGrid, mx, sxx):
    n = operand_check("svgp_match_fwd", "fwd", meta, g, mx, sxx)
    if mx.device.type == "cpu":
        return match_reference(meta, g, mx, sxx)
    num_l, d = meta.num_latent, meta.num_dim
    new = lambda *shape: torch.empty(shape, dtype=mx.dtype, device=mx.device)  # noqa: E731
    f1, sff, cross = new(n, num_l), new(n, num_l, num_l), new(n, d, num_l)
    scratch = new(n, meta.num_pairs, tile_count(meta) ** 2, 2)  # per tile: f2, sum Q o E
    name = f"svgp_match_fwd_{_SUFFIX[mx.dtype]}"
    _build.launch("mm_match", name, (mx, sxx, *g.tensors(), f1, sff, cross, scratch),
                  *_ints(meta, n))
    launches[name] += 1
    return f1, sff, cross


def _bwd(meta: MatchMeta, g: FusedMatchGrid, mx, sxx, f1, df1, dsff, dcross, frozen: bool):
    num_l, num_k, d = meta.num_latent, meta.num_latent + meta.num_pairs, meta.num_dim
    n = mx.shape[0]
    operand_check("svgp_match_bwd", "bwd_frozen" if frozen else "bwd", meta, g, mx, sxx,
                  ((f1, (n, num_l)), (df1, (n, num_l)), (dsff, (n, num_l, num_l)),
                   (dcross, (n, d, num_l))))
    if mx.device.type == "cpu":
        return match_reference_bwd(meta, g, mx, sxx, df1, dsff, dcross, frozen)
    dmx, dsxx = torch.empty_like(mx), torch.empty_like(sxx)
    new = lambda *shape: torch.empty(shape, dtype=mx.dtype, device=mx.device)  # noqa: E731
    gda, gdmx = new(n, num_k, d, d), new(n, num_k, d)  # the groups' cotangents
    ins = (mx, sxx, *g.tensors(), f1, df1, dsff, dcross)
    sfx = _SUFFIX[mx.dtype]
    if frozen:
        # the tile partials of e dE: 1 + D values per row (rp) and per column
        # (cq) for each batch entry, pair and tile along the other side
        rp = new(n, meta.num_pairs, tile_count(meta), d + 1, meta.num_m)
        cq = new(n, meta.num_pairs, tile_count(meta), d + 1, meta.num_m)
        name = f"svgp_match_bwd_frozen_{sfx}"
        _build.launch("mm_match", name, (*ins, dmx, dsxx, gda, gdmx, rp, cq), *_ints(meta, n))
        launches[name] += 1
        return dmx, dsxx, None
    # the grid cotangents: one flat buffer in GRID_FIELDS order, each field a
    # view of it; with a batch, the kernel's per-entry slots of it
    sizes = [t.numel() for t in g.tensors()]
    dgrid = new(sum(sizes))
    slots = new(n * dgrid.numel() if n > 1 else 0)
    name = f"svgp_match_bwd_{sfx}"
    _build.launch("mm_match", name, (*ins, dmx, dsxx, gda, gdmx, dgrid, slots), *_ints(meta, n))
    launches[name] += 1
    dts = [v.view_as(t) for v, t in zip(dgrid.split(sizes), g.tensors())]
    return dmx, dsxx, FusedMatchGrid(**dict(zip(GRID_FIELDS, dts)), meta=meta)


class FusedSVGPMatch(torch.autograd.Function):
    """(f1, sff, cross) from mx (N, D), sxx (N, D, D) and the grid's tensors.
    The backward is the frozen kernel when ``frozen`` is set or no grid
    tensor needs a gradient, else the full one."""

    @staticmethod
    def forward(ctx, mx, sxx, meta, frozen, *grid):
        g = FusedMatchGrid(**dict(zip(GRID_FIELDS, grid)), meta=meta)
        f1, sff, cross = _fwd(meta, g, mx, sxx)
        ctx.meta, ctx.frozen = meta, frozen
        ctx.save_for_backward(mx, sxx, f1, *grid)
        return f1, sff, cross

    @staticmethod
    def backward(ctx, df1, dsff, dcross):
        mx, sxx, f1, *grid = ctx.saved_tensors
        g = FusedMatchGrid(**dict(zip(GRID_FIELDS, grid)), meta=ctx.meta)
        frozen = ctx.frozen or not any(ctx.needs_input_grad[4:])
        dmx, dsxx, dg = _bwd(ctx.meta, g, mx, sxx, f1, df1.contiguous(), dsff.contiguous(),
                             dcross.contiguous(), frozen)
        dgrid = (None,) * len(GRID_FIELDS) if dg is None else tuple(
            t if need else None for t, need in zip(dg.tensors(), ctx.needs_input_grad[4:])
        )
        return (dmx, dsxx, None, None, *dgrid)


def fused_svgp_match(grid: FusedMatchGrid, mx, sxx, frozen: bool = False):
    """Whole-match op: mx (..., D), sxx (..., D, D) -> (f1 (..., L),
    sff (..., L, L), cross (..., D, L)). ``frozen=True`` emits cotangents
    for (mx, sxx) only; never set it where the model trains through the
    match."""
    meta = grid.meta
    d, num_l = meta.num_dim, meta.num_latent
    batch = mx.shape[:-1]
    f1, sff, cross = FusedSVGPMatch.apply(
        mx.reshape(-1, d).contiguous(), sxx.reshape(-1, d, d).contiguous(), meta, bool(frozen),
        *grid.tensors(),
    )
    return (f1.reshape(batch + (num_l,)), sff.reshape(batch + (num_l, num_l)),
            cross.reshape(batch + (d, num_l)))
