"""Closed-form moments of SVGP predictions under Gaussian inputs
(counterpart of the SVGP half of gpflowpilco_tpu/moment_matching/gp.py).

For x ~ N(m, S) and a latent-stacked SVGP with representer weights alpha_l,
using the kernel expectations of ops/kexp.py:

  E[f_l]            = eKfu[:, l] . alpha_l
  E[f_l1 f_l2]      = alpha_l1^T eKuffu[l1, :, l2, :] alpha_l2
  E[Cov_f]_l        = eKff_l - tr(Q_l eKuffu[l, :, l, :]),
                      Q_l = Kuu_l^{-1} - Kuu_l^{-1} Sq_l Kuu_l^{-1}
  S^{-1} Cov(x,f)_l = sum_m alpha_l[m] eKfu[m, l] (S + Lam_l)^{-1} (z_lm - m)

The cross-covariance comes pre-multiplied by Cov(x,x)^{-1} (preinv=True).

Not ported yet: the whole-match kernel (the TPU kernel K3, which the MM
loop's ``use_fused_match`` selects and which raises there), the
diagonal-only path (``full_output_cov=False`` without a mixing matrix, which
raises here) and GPR drifts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.gp import SVGP, chol_kuu, svgp_predict_f
from ..moments import GaussianMatch, GaussianMoments
from ..ops import kexp
from ..ops.kexp_cuda import FusedPairGrid, build_fused_pair_grid, ekuffu_contract_fused
from ..ops.linalg import bcho_solve
from ..ops.linalg import bsolve_triangular as solve_triangular


class SVGPMatchCache(NamedTuple):
    """Input-independent pieces of the SVGP moment rule, computed once per
    model: inside a rollout they are the same at every step (and across all
    optimizer steps for the frozen drift). ``qmat`` collapses the
    expected-covariance correction to one contraction against eKuffu's
    diagonal blocks."""

    luu: torch.Tensor  # (L, M, M)
    alpha: torch.Tensor  # (L, M) representer weights
    cct: torch.Tensor  # (L, M, M) projected q-covariance
    qmat: torch.Tensor  # (L, M, M) Kuu^{-1} - Luu^{-T} cct Luu^{-1}
    pairs: Optional[tuple]  # kexp.ekuffu_pair_cache terms (x-free eKuffu factors), unfused only
    fused_grid: Optional[FusedPairGrid] = None  # the pair-grid kernel's tensors (K2)


def svgp_match_cache(model: SVGP, fused: bool = False) -> SVGPMatchCache:
    luu = chol_kuu(model)
    q_mu = model.q_mu.T[..., None]  # (L, M, 1)
    if model.whiten:
        alpha = solve_triangular(luu, q_mu, lower=True, trans=1)[..., 0]
    else:
        alpha = bcho_solve(luu, q_mu)[..., 0]
    q_sqrt = torch.tril(model.q_sqrt)
    c = q_sqrt if model.whiten else solve_triangular(luu, q_sqrt, lower=True)
    cct = c @ c.mT
    eye = torch.eye(luu.shape[-1], dtype=luu.dtype, device=luu.device)
    kuu_inv = bcho_solve(luu, eye.expand(luu.shape))
    h = solve_triangular(luu, c, lower=True, trans=1)  # Luu^{-T} c
    qmat = kuu_inv - h @ h.mT
    fused_grid = build_fused_pair_grid(model.kernel, model.z, alpha, qmat) if fused else None
    return SVGPMatchCache(
        luu=luu,
        alpha=alpha,
        cct=cct,
        qmat=qmat,
        pairs=None if fused else kexp.ekuffu_pair_cache(model.kernel, model.z),
        fused_grid=fused_grid,
    )


class SVGPTransform:
    """Moment-matchable SVGP posterior. ``deterministic=True`` is the PILCO
    kernel-regressor policy: no model uncertainty, the prediction is the
    posterior mean. ``fused=True`` routes the eKuffu pair grid through the
    CUDA contraction kernel (ops/kexp_cuda.py; its plain version on the
    CPU)."""

    def __init__(
        self,
        model: SVGP,
        deterministic: bool = False,
        jitter: float = 0.0,
        fused: bool = False,
        cache: Optional[SVGPMatchCache] = None,
    ):
        self.model = model
        self.deterministic = deterministic
        self.jitter = jitter
        self.fused = fused
        self.cache = cache

    def with_cache(self) -> "SVGPTransform":
        return SVGPTransform(
            self.model, self.deterministic, self.jitter, self.fused,
            svgp_match_cache(self.model, fused=self.fused),
        )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.cache is not None:
            # mean from the hoisted representer weights: one gram and one
            # contraction per call instead of a fresh Cholesky and solves
            kxu = self.model.kernel.gram(x[..., None, :, :], self.model.z)  # (..., L, N, M)
            mean_lat = torch.einsum("...lnm,lm->...nl", kxu, self.cache.alpha)
            mean = mean_lat @ self.model.w.T if self.model.w is not None else mean_lat
            return mean + self.model.mean_const
        return svgp_predict_f(self.model, x)[0]

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        return match_svgp(
            self.model, x, model_uncertainty=not self.deterministic,
            jitter=self.jitter, cache=self.cache,
        )


def _add_jitter_diag(mat, jitter):
    if not jitter:
        return mat
    return mat + jitter * torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)


def match_svgp(
    model: SVGP,
    x: GaussianMoments,
    model_uncertainty: bool = True,
    jitter: float = 0.0,
    full_output_cov: bool = True,
    cache: Optional[SVGPMatchCache] = None,
) -> GaussianMatch:
    """``full_output_cov=False`` diagonalizes the output covariance after
    mixing; without a mixing matrix it would take the diagonal-only path,
    which is not ported yet."""
    if not full_output_cov and model.w is None:
        raise NotImplementedError("the diagonal-only eKuffu path is not ported yet")
    mx, sxx = x.mean, x.cov
    kern, z = model.kernel, model.z  # z (L, M, D)
    if cache is None:
        cache = svgp_match_cache(model)
    alpha = cache.alpha
    num_latent = z.shape[0]

    # eKfu and the premultiplied cross-cov solve share one (L, D, D) Cholesky
    ekfu, iv_dx = kexp.ekxz_isolve(kern.variance, kexp.latent_lam(kern, z.shape[-1]), z, mx, sxx)
    f1_lat = torch.einsum("...ml,lm->...l", ekfu, alpha)  # (..., L)

    if cache.fused_grid is not None:
        # kernel path: the (P, M, M) exp blocks are never stored, only the
        # alpha- and Q-contracted vectors come back
        f2_lat, ecov_corr = ekuffu_contract_fused(cache.fused_grid, mx, sxx)
    else:
        ekuffu = kexp.ekuffu_mo_from_cache(cache.pairs, num_latent, mx, sxx)  # (..., L, M, L, M)
        f2_lat = torch.einsum("im,...imjn,jn->...ij", alpha, ekuffu, alpha)  # (..., L, L)
        if model_uncertainty:
            blk = torch.stack([ekuffu[..., l, :, l, :] for l in range(num_latent)], dim=-3)
            ecov_corr = torch.einsum("lmn,...lmn->...l", cache.qmat, blk)
    sff_lat = f2_lat - f1_lat[..., :, None] * f1_lat[..., None, :]
    if model_uncertainty:
        # tr(Q blk) without per-step (L, M, M) triangular solves (qmat cached)
        sff_lat = sff_lat + torch.diag_embed(kern.variance - ecov_corr)

    cross_lat = torch.einsum("lm,...ml,...ldm->...dl", alpha, ekfu, iv_dx)  # (..., D, L)

    if model.w is not None:
        w = model.w
        f1 = f1_lat @ w.T
        sff = torch.einsum("pi,...ij,qj->...pq", w, sff_lat, w)
        cross = cross_lat @ w.T
    else:
        f1, sff, cross = f1_lat, sff_lat, cross_lat
    f1 = f1 + model.mean_const
    sff = _add_jitter_diag(sff, jitter)
    if not full_output_cov:
        sff = torch.diag_embed(torch.diagonal(sff, dim1=-2, dim2=-1))
    return GaussianMatch(x=x, y=GaussianMoments(mean=f1, cov=sff), cross=cross, preinv=True)
