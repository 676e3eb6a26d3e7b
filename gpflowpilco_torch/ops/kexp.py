"""Gaussian integrals of RBF kernels: the PILCO kernel-expectation quadratics
(counterpart of gpflowpilco_tpu/ops/kexp.py).

With k(x, z) = s^2 exp(-1/2 (x-z)^T Lam^{-1} (x-z)), Lam = diag(l^2) and
x ~ N(m, S):

  eKxz[m]      = s^2 sqrt(|Lam|/|S+Lam|) exp(-1/2 (z_m-m)^T (S+Lam)^{-1} (z_m-m))
  eKzxxz[i,j]  = zfac_ij sqrt(|V|/|S+V|) exp(-1/2 (c_ij-m)^T (S+V)^{-1} (c_ij-m))

where V = (Lam1^{-1}+Lam2^{-1})^{-1}, c_ij = u_i + w_j with u_i = V Lam1^{-1}
z1_i and w_j = V Lam2^{-1} z2_j, and zfac_ij = s1^2 s2^2 exp(-1/2 (z1_i-z2_j)^T
(Lam1+Lam2)^{-1} (z1_i-z2_j)). The (c_ij - m) quadratic is expanded, so no
(M1, M2, D) tensor is formed.

These make up the unfused eKuffu path (the JAX package's default when the
pair-grid kernel is off), its diagonal-only blocks and the single- and
multi-output wrappers; ``ops/kexp_cuda.py`` holds the fused pair grid.
Leading batch dimensions of (mx, sxx) broadcast. The per-step D x D Cholesky
factorizations return NaN on failure (``ops/linalg.cholesky_nan``).
"""
from __future__ import annotations

import torch

from .linalg import bsolve_triangular, cholesky_nan


def _bc_lengthscales(ls, d: int):
    """Lengthscales as a (..., D) vector: a scalar is broadcast to (d,)."""
    ls = torch.as_tensor(ls)
    if ls.dim() == 0:
        ls = ls.expand(d)
    return ls


def latent_lam(kernel, d: int) -> torch.Tensor:
    """Per-latent squared lengthscales broadcast to (L, D)."""
    lam = kernel.lengthscales**2
    if lam.dim() == 1:  # (L,) isotropic per latent
        lam = lam[:, None]
    return lam.expand(lam.shape[0], d)


def ekff(variance, mx):
    """E[k(x, x)] for an RBF kernel: the variance, broadcast to (...,)."""
    return torch.as_tensor(variance, dtype=mx.dtype, device=mx.device).expand(mx.shape[:-1])


def ekxz(variance, lengthscales, z, mx, sxx):
    """E[k(x, Z)]: mx (..., D), sxx (..., D, D), z (M, D) -> (..., M).
    Kernels stacked on leading dims of variance (K,), lengthscales (K, D)
    and z (K, M, D) broadcast against the batch dims of (mx, sxx)."""
    dt = dict(dtype=mx.dtype, device=mx.device)
    lam = _bc_lengthscales(torch.as_tensor(lengthscales, **dt), z.shape[-1]) ** 2
    chol = cholesky_nan(sxx + torch.diag_embed(lam))
    diff = z - mx[..., None, :]  # (..., M, D)
    il_diff = bsolve_triangular(chol, diff.mT, lower=True)
    quad = torch.sum(il_diff * il_diff, dim=-2)  # (..., M)
    half_logdet_s = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    log_det_term = 0.5 * torch.sum(torch.log(lam), dim=-1) - half_logdet_s
    return torch.as_tensor(variance, **dt)[..., None] * torch.exp(log_det_term[..., None] - 0.5 * quad)


def ekxz_isolve(variance, lam, z, mx, sxx):
    """E[k(x, Z)] and (S + Lam)^{-1} (Z - m) over a latent-stacked RBF, from
    one Cholesky of (S + Lam_l).

    variance (L,), lam (L, D), z (L, M, D), mx (..., D), sxx (..., D, D) ->
    ekfu (..., M, L), iv_dx (..., L, D, M).
    """
    v = sxx[..., None, :, :] + torch.diag_embed(lam)  # (..., L, D, D)
    chol = cholesky_nan(v)
    dx = z - mx[..., None, None, :]  # (..., L, M, D)
    il_dx = bsolve_triangular(chol, dx.mT, lower=True)  # (..., L, D, M)
    quad = torch.sum(il_dx * il_dx, dim=-2)  # (..., L, M)
    half_logdet_lam = 0.5 * torch.sum(torch.log(lam), dim=-1)  # (L,)
    half_logdet_s = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    log_det_term = half_logdet_lam - half_logdet_s  # (..., L)
    ekfu = variance[:, None] * torch.exp(log_det_term[..., None] - 0.5 * quad)
    iv_dx = bsolve_triangular(chol, il_dx, lower=True, trans=1)  # (..., L, D, M)
    return ekfu.mT, iv_dx


def ekzxxz_pair_terms(v1, l1, z1, v2, l2, z2):
    """State-independent factors of eKzxxz for kernel pairs stacked on any
    leading dims: (vdiag (..., D), u (..., M1, D), w (..., M2, D),
    log_pref (..., M1, M2)) with log_pref = log(v1 v2) + 0.5 log|V| - zquad/2.
    """
    d = z1.shape[-1]
    lam1 = _bc_lengthscales(l1, d) ** 2
    lam2 = _bc_lengthscales(l2, d) ** 2
    lam_sum = lam1 + lam2
    v = lam1 * lam2 / lam_sum  # diag of V

    u = z1 * (lam2 / lam_sum)[..., None, :]  # (..., M1, D)
    w = z2 * (lam1 / lam_sum)[..., None, :]  # (..., M2, D)

    # x-free Gaussian factor between the two inducing sets
    inv_sqrt = torch.sqrt(1.0 / lam_sum)[..., None, :]
    g1 = z1 * inv_sqrt
    g2 = z2 * inv_sqrt
    g11 = torch.sum(g1 * g1, dim=-1)
    g22 = torch.sum(g2 * g2, dim=-1)
    zquad = g11[..., :, None] + g22[..., None, :] - 2.0 * (g1 @ g2.mT)  # (..., M1, M2)

    half_logdet_v = 0.5 * torch.sum(torch.log(v), dim=-1)
    log_pref = (torch.log(v1 * v2) + half_logdet_v)[..., None, None] - 0.5 * zquad
    return v, u, w, log_pref


def ekzxxz_from_terms(vdiag, u, w, log_pref, mx, sxx):
    """Per-step part of eKzxxz from ``ekzxxz_pair_terms``: one D x D
    Cholesky, three triangular solves and the exp assembly. The pair dims of
    the terms broadcast against the batch dims of (mx, sxx)."""
    chol = cholesky_nan(sxx + torch.diag_embed(vdiag))

    il_m = bsolve_triangular(chol, mx[..., :, None], lower=True)  # (..., D, 1)
    il_u = bsolve_triangular(chol, u.mT, lower=True)  # (..., D, M1)
    il_w = bsolve_triangular(chol, w.mT, lower=True)  # (..., D, M2)

    uu = torch.sum(il_u * il_u, dim=-2)  # (..., M1)
    ww = torch.sum(il_w * il_w, dim=-2)  # (..., M2)
    mm = torch.sum(il_m * il_m, dim=(-2, -1))  # (...,)
    uw = il_u.mT @ il_w  # (..., M1, M2)
    um = torch.sum(il_u * il_m, dim=-2)  # (..., M1)
    wm = torch.sum(il_w * il_m, dim=-2)  # (..., M2)

    quad = (
        mm[..., None, None]
        + (uu - 2.0 * um)[..., :, None]
        + (ww - 2.0 * wm)[..., None, :]
        + 2.0 * uw
    )
    half_logdet_s = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return torch.exp(log_pref - (half_logdet_s[..., None, None] + 0.5 * quad))


def ekzxxz(v1, l1, z1, v2, l2, z2, mx, sxx):
    """E[k1(Z1, x) k2(x, Z2)] -> (..., M1, M2) (the module docstring's
    algebra)."""
    return ekzxxz_from_terms(*ekzxxz_pair_terms(v1, l1, z1, v2, l2, z2), mx, sxx)


# ----------------------------------------------------------------------------
# multi-output (latent-stacked) variants: the latents ride the kernels'
# batch axis, in front of the batch dims of (mx, sxx)
# ----------------------------------------------------------------------------
def ekff_mo(kernel, mx):
    """(..., L): per-latent E[k(x, x)]."""
    var = kernel.variance
    return var.expand(mx.shape[:-1] + var.shape)


def ekfu_mo(kernel, z, mx, sxx):
    """Stacked E[k_l(x, Z_l)]: z (L, M, D) -> (..., M, L)."""
    out = ekxz(kernel.variance, kernel.lengthscales, z, mx[..., None, :], sxx[..., None, :, :])
    return out.mT  # (..., L, M) -> (..., M, L)


def ekuffu_diag_cache(kernel, z):
    """State-independent terms of the diagonal latent blocks only: the
    pair terms of (l, l) for every latent l."""
    var, ls = kernel.variance, kernel.lengthscales
    return ekzxxz_pair_terms(var, ls, z, var, ls, z)


def ekuffu_mo_diag_from_cache(diag_cache, mx, sxx):
    """Diagonal latent blocks from ``ekuffu_diag_cache`` -> (..., L, M, M)."""
    return ekzxxz_from_terms(*diag_cache, mx[..., None, :], sxx[..., None, :, :])


def ekuffu_mo_diag(kernel, z, mx, sxx):
    """Diagonal latent blocks E[k_l(Z_l, x) k_l(x, Z_l)]: z (L, M, D) ->
    (..., L, M, M), the L(L-1)/2 cross-latent blocks never formed (the
    diagonal-only match)."""
    return ekuffu_mo_diag_from_cache(ekuffu_diag_cache(kernel, z), mx, sxx)


def latent_pairs(num_latent: int):
    """The upper-triangular latent pairs (i, j), i <= j, in grid order."""
    return [(i, j) for i in range(num_latent) for j in range(i, num_latent)]


def ekuffu_pair_cache(kernel, z):
    """State-independent pair terms of the upper-triangular latent-pair grid:
    (vdiag (P, D), u (P, M, D), w (P, M, D), log_pref (P, M, M))."""
    pairs = latent_pairs(z.shape[0])
    i_idx = torch.tensor([p[0] for p in pairs], device=z.device)
    j_idx = torch.tensor([p[1] for p in pairs], device=z.device)
    var, ls = kernel.variance, kernel.lengthscales
    return ekzxxz_pair_terms(var[i_idx], ls[i_idx], z[i_idx], var[j_idx], ls[j_idx], z[j_idx])


def ekuffu_mo_from_cache(pair_cache, num_latent: int, mx, sxx):
    """Per-step eKuffu from hoisted pair terms -> (..., L, M, L, M). The lower
    triangle mirrors the upper by one gather and a masked transpose (adjoint
    symmetry: E[k_j k_i] = E[k_i k_j]^T)."""
    vdiag, u, w, log_pref = pair_cache
    out = ekzxxz_from_terms(vdiag, u, w, log_pref, mx[..., None, :], sxx[..., None, :, :])
    lut_map = {p: k for k, p in enumerate(latent_pairs(num_latent))}
    lut = torch.tensor(
        [[lut_map[(min(i, j), max(i, j))] for j in range(num_latent)] for i in range(num_latent)],
        device=out.device,
    )  # (L, L)
    tmask = torch.tensor(
        [[i > j for j in range(num_latent)] for i in range(num_latent)], device=out.device
    )  # True where the mirrored (transposed) block is needed
    full = out[..., lut, :, :]  # (..., L1, L2, M1, M2)
    full = torch.where(tmask[:, :, None, None], full.mT, full)
    return full.transpose(-3, -2)  # (..., L1, M1, L2, M2)


def ekuffu_mo(kernel, z, mx, sxx):
    """Stacked E[k_i(Z_i, x) k_j(x, Z_j)]: z (L, M, D) -> (..., L, M, L, M),
    from the upper-triangular pairs and their mirror."""
    return ekuffu_mo_from_cache(ekuffu_pair_cache(kernel, z), z.shape[0], mx, sxx)
