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
pair-grid kernel is off); ``ops/kexp_cuda.py`` holds the fused one. Leading
batch dimensions of (mx, sxx) broadcast. The per-step D x D Cholesky
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
