"""Fused eKuffu pair-grid contraction: the CUDA kernel op
(counterpart of gpflowpilco_tpu/ops/kexp_pallas.py).

The MM drift and policy matches need, for every latent pair (i, j), the
(M, M) block E_ij of eKuffu only through two reductions: f2[i,j] =
alpha_i^T E_ij alpha_j and ecov_i = sum(Q_i * E_ii). The exponent is a
bilinear form, E = exp(-su^T sw) with su = [u'; g1; a_u; 1] and
sw = [w'; -g2; 0.5; 0.5 a_w] (u' = L^{-1}u - L^{-1}m/2 etc.), which also keeps
every exponent <= 0. ``FusedPairContract`` takes (su, sw, alu, qm) and gives

    evc[n, p] = alu[p] @ E[n, p]   (R, M)      qcol[n, p] = colsum(qm[p] * E[n, p])   (M,)

with a leading batch N on su and sw (and on evc, qcol and their cotangents);
alu (P, R, M) and qm (P, M, M) are shared across the batch. It saves its
inputs and the backward recomputes E. The backward picks, from
``ctx.needs_input_grad``, the frozen kernel (alu and qm need no gradient: the
drift inside a policy optimization) or the full one.

Dispatch is by the device of the tensors: CUDA tensors go to the kernels of
``csrc/kexp_pair.cu`` (float32 or float64, contiguous, else the wrapper
raises), CPU tensors to ``pair_contract_reference`` and its backward
formulas. There is no fallback from one to the other. ``launches`` counts
kernel launches only (a call of the frozen backward's tiles and finish
counts once). The frozen backward cuts each (n, p) grid into
FROZEN_TILE x FROZEN_TILE tiles on the block grid; the wrapper allocates
their row and column partials (``frozen_partials``).

The GPR match (``build_fused_gpr_grid``, ``ekuffu_contract_gpr``) uses
the same kernels with one symmetric (X, X) pair per model, the training
inputs in M's place, and R = 4 rows of alpha^T; an ensemble's members sit on
the pair axis P.

Unlike the TPU kernel, M is not padded to 128 and D2 = 2D + 2 is not padded
to 8: the kernel masks the ragged edge itself.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build, kexp
from .linalg import bsolve_triangular, cholesky_nan

# kernel launches per entry; reset with reset_launches()
launches = {
    f"pair_contract_{kind}_{sfx}": 0
    for kind in ("fwd", "bwd", "bwd_frozen")
    for sfx in ("f32", "f64")
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_MAX_D2, _MAX_R = 32, 4  # kMaxD2, kMaxR in csrc/kexp_pair.cu
FROZEN_TILE = 32  # the frozen backward's tile side, kFT in csrc/kexp_pair.cu


def reset_launches():
    for k in launches:
        launches[k] = 0


def operand_shape(su, sw, alu, qm, devc=None, dqcol=None):
    """(N, P, D2, M, R) of the operands; raises ValueError unless every
    operand has the shape the kernels index it by (D2 <= 32, R <= 4), and
    TypeError unless all share one float32 or float64 dtype."""
    n, p, d2, m = su.shape
    r = alu.shape[1]
    want = {
        "sw": (sw, (n, p, d2, m)), "alu": (alu, (p, r, m)), "qm": (qm, (p, m, m)),
    }
    if devc is not None:
        want["devc"] = (devc, (n, p, r, m))
        want["dqcol"] = (dqcol, (n, p, m))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"pair contract: {name} has shape {tuple(t.shape)}, expected {shape}")
    if d2 > _MAX_D2 or r > _MAX_R:
        raise ValueError(f"pair contract: the kernels take D2 <= {_MAX_D2} and R <= {_MAX_R}, "
                         f"got D2={d2}, R={r}")
    dtypes = {t.dtype for t in (su, *(t for t, _ in want.values()))}
    if len(dtypes) != 1 or su.dtype not in _SUFFIX:
        raise TypeError(f"pair contract: operands must share float32 or float64, got {dtypes}")
    return n, p, d2, m, r


def _launch(kind: str, inputs, outputs, shape):
    """Check the operands and launch ``pair_contract_<kind>_<dtype>`` on the
    current stream."""
    name = f"pair_contract_{kind}_{_SUFFIX[inputs[0].dtype]}"
    _build.launch("kexp_pair", name, (*inputs, *outputs), *(ctypes.c_int(v) for v in shape))
    launches[name] += 1


def frozen_partials(n, p, d2, m, like):
    """The frozen backward's scratch: dsu's row partials (N, P, ceil(M /
    FROZEN_TILE), D2, M), one slab per column tile, then dsw's column
    partials, one per row tile; empty when one tile covers M (the kernel
    then writes dsu and dsw itself)."""
    nt = -(-m // FROZEN_TILE)
    shape = (2, n, p, nt, d2, m) if nt > 1 else (0,)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


# ----------------------------------------------------------------- plain torch
def _exp_grid(su, sw):
    """E (N, P, M, M) = exp(-su^T sw)."""
    return torch.exp(-(su.mT @ sw))


def pair_contract_reference(su, sw, alu, qm):
    """Plain-torch (evc (N, P, R, M), qcol (N, P, M)): the kernel's inputs
    and outputs."""
    e = _exp_grid(su, sw)
    return alu @ e, torch.sum(qm * e, dim=-2)


def pair_contract_reference_bwd(su, sw, alu, qm, devc, dqcol, want_model):
    """Plain-torch backward: dsu, dsw, and dalu, dqm summed over the batch
    when ``want_model`` (else None)."""
    e = _exp_grid(su, sw)
    g = -e * (alu.mT @ devc + qm * dqcol[..., None, :])  # (N, P, M, M)
    dsu = sw @ g.mT
    dsw = su @ g
    if not want_model:
        return dsu, dsw, None, None
    dalu = torch.sum(devc @ e.mT, dim=0)
    dqm = torch.sum(e * dqcol[..., None, :], dim=0)
    return dsu, dsw, dalu, dqm


# ----------------------------------------------------------------- dispatch
def _fwd(su, sw, alu, qm):
    shape = operand_shape(su, sw, alu, qm)
    if su.device.type == "cpu":
        return pair_contract_reference(su, sw, alu, qm)
    n, p, _, m, r = shape
    evc = torch.empty((n, p, r, m), dtype=su.dtype, device=su.device)
    qcol = torch.empty((n, p, m), dtype=su.dtype, device=su.device)
    _launch("fwd", (su, sw, alu, qm), (evc, qcol), shape)
    return evc, qcol


def _bwd(su, sw, alu, qm, devc, dqcol, want_model):
    shape = operand_shape(su, sw, alu, qm, devc, dqcol)
    if su.device.type == "cpu":
        return pair_contract_reference_bwd(su, sw, alu, qm, devc, dqcol, want_model)
    dsu, dsw = torch.empty_like(su), torch.empty_like(sw)
    if not want_model:
        part = frozen_partials(*shape[:4], su)
        _launch("bwd_frozen", (su, sw, alu, qm, devc, dqcol), (dsu, dsw, part), shape)
        return dsu, dsw, None, None
    dalu, dqm = torch.empty_like(alu), torch.empty_like(qm)
    _launch("bwd", (su, sw, alu, qm, devc, dqcol), (dsu, dsw, dalu, dqm), shape)
    return dsu, dsw, dalu, dqm


class FusedPairContract(torch.autograd.Function):
    """(evc, qcol) from su, sw (N, P, D2, M), alu (P, R, M), qm (P, M, M)."""

    @staticmethod
    def forward(ctx, su, sw, alu, qm):
        ctx.save_for_backward(su, sw, alu, qm)
        return _fwd(su, sw, alu, qm)

    @staticmethod
    def backward(ctx, devc, dqcol):
        su, sw, alu, qm = ctx.saved_tensors
        want_model = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        dsu, dsw, dalu, dqm = _bwd(
            su, sw, alu, qm, devc.contiguous(), dqcol.contiguous(), want_model
        )
        need = ctx.needs_input_grad
        return (
            dsu if need[0] else None,
            dsw if need[1] else None,
            dalu if need[2] else None,
            dqm if need[3] else None,
        )


# ------------------------------------------------------------- state-free grid
@dataclass(frozen=True)
class FusedPairGrid:
    """State-independent tensors of the latent-pair grid, built once per
    model by the match cache (cf. SVGPMatchCache). Not padded."""

    vdiag: torch.Tensor  # (P, D)
    ut: torch.Tensor  # (P, D, M) u^T
    wt: torch.Tensor  # (P, D, M)
    g1t: torch.Tensor  # (P, D, M)
    g2t: torch.Tensor  # (P, D, M)
    g11: torch.Tensor  # (P, M)
    g22: torch.Tensor  # (P, M)
    cp: torch.Tensor  # (P,) log(v1 v2) + 0.5 log|V|
    alpha_u: torch.Tensor  # (P, M) alpha[i(p)]
    alpha_w: torch.Tensor  # (P, M) alpha[j(p)]
    qm: torch.Tensor  # (P, M, M) Q_{i(p)} for diagonal pairs, zeros otherwise
    scatter: torch.Tensor  # (P, L*L) 0/1 f2 scatter (mirrors the lower triangle)
    diag_pos: torch.Tensor  # (L,) pair index of (l, l)
    num_latent: int


def build_fused_pair_grid(kernel, z, alpha, qmat) -> FusedPairGrid:
    """kernel: latent-stacked RBF; z (L, M, D); alpha (L, M); qmat (L, M, M)."""
    num_latent, num_m, d = z.shape
    pairs = kexp.latent_pairs(num_latent)
    i_idx = torch.tensor([p[0] for p in pairs], device=z.device)
    j_idx = torch.tensor([p[1] for p in pairs], device=z.device)
    var, ls = kernel.variance, kernel.lengthscales
    vdiag, u, w, _ = kexp.ekzxxz_pair_terms(
        var[i_idx], ls[i_idx], z[i_idx], var[j_idx], ls[j_idx], z[j_idx]
    )
    # the z-side factors stay in vector form: zquad is rebuilt inside E
    lam_i = kexp._bc_lengthscales(ls[i_idx], d) ** 2
    lam_j = kexp._bc_lengthscales(ls[j_idx], d) ** 2
    inv_sqrt = torch.sqrt(1.0 / (lam_i + lam_j))[:, None, :]  # (P, 1, D)
    g1 = z[i_idx] * inv_sqrt  # (P, M, D)
    g2 = z[j_idx] * inv_sqrt
    cp = torch.log(var[i_idx] * var[j_idx]) + 0.5 * torch.sum(torch.log(vdiag), -1)

    lut = {p: k for k, p in enumerate(pairs)}
    # f2 is symmetric, so each upper-triangular pair scatters to (i, j) and
    # (j, i); a diagonal pair writes its slot once
    scatter = torch.zeros((len(pairs), num_latent * num_latent), dtype=z.dtype)
    for k, (i, j) in enumerate(pairs):
        scatter[k, i * num_latent + j] = 1.0
        scatter[k, j * num_latent + i] = 1.0
    zeros = torch.zeros((num_m, num_m), dtype=z.dtype, device=z.device)
    qm = torch.stack([qmat[i] if i == j else zeros for i, j in pairs])

    return FusedPairGrid(
        vdiag=vdiag,
        ut=u.mT.contiguous(),
        wt=w.mT.contiguous(),
        g1t=g1.mT.contiguous(),
        g2t=g2.mT.contiguous(),
        g11=torch.sum(g1 * g1, -1),
        g22=torch.sum(g2 * g2, -1),
        cp=cp,
        alpha_u=alpha[i_idx],
        alpha_w=alpha[j_idx],
        qm=qm,
        scatter=scatter.to(z.device),
        diag_pos=torch.tensor([lut[(l, l)] for l in range(num_latent)], device=z.device),
        num_latent=num_latent,
    )


def ekuffu_contract_fused(grid: FusedPairGrid, mx, sxx):
    """mx (..., D), sxx (..., D, D) ->
    f2_lat (..., L, L) = alpha_i^T eKuffu_ij alpha_j and
    ecov_corr (..., L) = sum(Q_l * eKuffu_ll) (the expected-cov trace term).
    The batch dims are flattened into the kernel's leading N."""
    batch = mx.shape[:-1]
    d = mx.shape[-1]
    mx = mx.reshape(-1, 1, d)  # (N, 1, D)
    sxx = sxx.reshape(-1, 1, d, d)
    num_n, num_m = mx.shape[0], grid.ut.shape[-1]
    num_pairs = grid.ut.shape[0]

    chol = cholesky_nan(sxx + torch.diag_embed(grid.vdiag))  # (N, P, D, D)
    # one batched solve for both inducing-set factors, one for the mean
    il_uw = bsolve_triangular(chol, torch.cat([grid.ut, grid.wt], dim=-1), lower=True)
    il_u, il_w = il_uw[..., :num_m], il_uw[..., num_m:]
    il_m = bsolve_triangular(chol, mx[..., None], lower=True)  # (N, P, D, 1)
    up = il_u - 0.5 * il_m
    wp = il_w - 0.5 * il_m
    a_u = torch.sum(up * up, dim=-2) + grid.g11  # (N, P, M)
    a_w = torch.sum(wp * wp, dim=-2) + grid.g22

    ones = torch.ones((num_n, num_pairs, 1, num_m), dtype=mx.dtype, device=mx.device)
    su = torch.cat([up, grid.g1t.expand(num_n, -1, -1, -1), a_u[:, :, None, :], ones], dim=-2)
    sw = torch.cat(
        [wp, -grid.g2t.expand(num_n, -1, -1, -1), 0.5 * ones, 0.5 * a_w[:, :, None, :]], dim=-2
    )
    evc, qcol = FusedPairContract.apply(su, sw, grid.alpha_u[:, None, :], grid.qm)

    hls = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)  # (N, P)
    esc = torch.exp(grid.cp - hls)
    f2_pairs = esc * torch.sum(evc[:, :, 0, :] * grid.alpha_w, dim=-1)  # (N, P)
    num_latent = grid.num_latent
    f2_lat = (f2_pairs @ grid.scatter).reshape(batch + (num_latent, num_latent))
    ecov_pairs = esc * torch.sum(qcol, dim=-1)  # (N, P)
    ecov_corr = ecov_pairs[:, grid.diag_pos].reshape(batch + (num_latent,))
    return f2_lat, ecov_corr


# ------------------------------------------------------------- GPR (X, X) pair
@dataclass(frozen=True)
class FusedGPRGrid:
    """State-independent tensors of the GPR match's single symmetric (X, X)
    pair, with a member axis K in front (K = 1 for one GPR). Under the
    shared kernel u = w = X/2, so only the affine rows differ between su and
    sw. The members go on the kernel's pair axis P: one launch serves every
    member, and no member computes another's grid."""

    vdiag: torch.Tensor  # (K, D)
    ut: torch.Tensor  # (K, D, N)
    g1t: torch.Tensor  # (K, D, N)
    g11: torch.Tensor  # (K, N)
    cp: torch.Tensor  # (K,) log v^2 + 0.5 log|V|
    alphat: torch.Tensor  # (K, R, N) alpha^T: R = P outputs rows
    qm: torch.Tensor  # (K, N, N) Kyy^{-1}


def gpr_pair_factors(variance, lengthscales, xdata):
    """The x-free factors of a GPR's symmetric (X, X) pair, with a member
    axis K: variance (K,), lengthscales (K, D), xdata (N, D) ->
    (vdiag (K, D), ut (K, D, N), g1t (K, D, N), g11 (K, N), cp (K,))."""
    vdiag, u, _, _ = kexp.ekzxxz_pair_terms(variance, lengthscales, xdata, variance, lengthscales, xdata)
    g1 = xdata * torch.sqrt(1.0 / (2.0 * lengthscales**2))[:, None, :]  # (K, N, D)
    cp = torch.log(variance * variance) + 0.5 * torch.sum(torch.log(vdiag), -1)
    return vdiag, u.mT.contiguous(), g1.mT.contiguous(), torch.sum(g1 * g1, -1), cp


def build_fused_gpr_grid(variance, lengthscales, xdata, alpha, kyy_inv) -> FusedGPRGrid:
    """variance () or (K,); lengthscales (D,) or (K, D); xdata (N, D);
    alpha (..., N, R); kyy_inv (..., N, N). The kernel takes R <= 4: the
    cartpole drift's 4 outputs, and the double pendulum's GPR (also 4)."""
    lift = (lambda a: a) if variance.dim() > 0 else (lambda a: a[None])  # noqa: E731
    vdiag, ut, g1t, g11, cp = gpr_pair_factors(lift(variance), lift(lengthscales), xdata)
    return FusedGPRGrid(
        vdiag=vdiag, ut=ut, g1t=g1t, g11=g11, cp=cp,
        alphat=lift(alpha).mT.contiguous(),
        qm=lift(kyy_inv).contiguous(),
    )


def gpr_pair_operands(grid: FusedGPRGrid, mx, sxx):
    """The kernel's operands for moments mx (B, K, D), sxx (B, K, D, D):
    (su, sw (B, K, 2D + 2, N), chol (B, K, D, D) of S + V)."""
    num_b, num_k, _ = mx.shape
    num_n = grid.ut.shape[-1]
    chol = cholesky_nan(sxx + torch.diag_embed(grid.vdiag))
    il_u = bsolve_triangular(chol, grid.ut, lower=True)  # (B, K, D, N)
    il_m = bsolve_triangular(chol, mx[..., None], lower=True)  # (B, K, D, 1)
    up = il_u - 0.5 * il_m
    a_u = torch.sum(up * up, dim=-2) + grid.g11  # (B, K, N)
    ones = torch.ones((num_b, num_k, 1, num_n), dtype=mx.dtype, device=mx.device)
    g1t = grid.g1t.expand(num_b, -1, -1, -1)
    su = torch.cat([up, g1t, a_u[:, :, None, :], ones], dim=-2)
    sw = torch.cat([up, -g1t, 0.5 * ones, 0.5 * a_u[:, :, None, :]], dim=-2)
    return su, sw, chol


def ekuffu_contract_gpr(grid: FusedGPRGrid, mx, sxx):
    """mx (..., D), sxx (..., D, D) -> f2 (..., R, R) = alpha^T eKuffu alpha
    and ecov_corr (...,) = sum(Kyy^{-1} * eKuffu). For a stacked grid the
    last batch axis of the moments is the member axis."""
    num_k, d, _ = grid.ut.shape
    batch = mx.shape[:-1]
    su, sw, chol = gpr_pair_operands(grid, mx.reshape(-1, num_k, d), sxx.reshape(-1, num_k, d, d))
    evc, qcol = FusedPairContract.apply(su, sw, grid.alphat, grid.qm)
    hls = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)  # (B, K)
    esc = torch.exp(grid.cp - hls)
    f2 = esc[..., None, None] * (evc @ grid.alphat.mT)  # (B, K, R, R)
    ecov_corr = esc * torch.sum(qcol, dim=-1)  # (B, K)
    r = grid.alphat.shape[1]
    return f2.reshape(batch + (r, r)), ecov_corr.reshape(batch)
