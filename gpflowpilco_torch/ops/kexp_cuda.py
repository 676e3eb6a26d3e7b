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
kernel launches only.

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
_NPTR = {"fwd": 6, "bwd": 10, "bwd_frozen": 8}
_MAX_D2, _MAX_R = 32, 4  # kMaxD2, kMaxR in csrc/kexp_pair.cu
_entries = {}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("kexp_pair"), name)
        kind = name[len("pair_contract_"):-len("_f32")]
        fn.argtypes = [ctypes.c_void_p] * _NPTR[kind] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


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
    device, dtype = inputs[0].device, inputs[0].dtype
    name = f"pair_contract_{kind}_{_SUFFIX[dtype]}"
    for t in (*inputs, *outputs):
        if t.device != device or not t.is_contiguous():
            raise TypeError(
                f"{name}: the CUDA kernel takes contiguous tensors on one device, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry(name)(
        *(t.data_ptr() for t in (*inputs, *outputs)), *shape, ctypes.c_void_p(stream)
    )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launches[name] += 1


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
        _launch("bwd_frozen", (su, sw, alu, qm, devc, dqcol), (dsu, dsw), shape)
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
