"""Closed-form moments of SVGP and GPR predictions under Gaussian inputs
(counterpart of gpflowpilco_tpu/moment_matching/gp.py).

For x ~ N(m, S) and a latent-stacked SVGP with representer weights alpha_l,
using the kernel expectations of ops/kexp.py:

  E[f_l]            = eKfu[:, l] . alpha_l
  E[f_l1 f_l2]      = alpha_l1^T eKuffu[l1, :, l2, :] alpha_l2
  E[Cov_f]_l        = eKff_l - tr(Q_l eKuffu[l, :, l, :]),
                      Q_l = Kuu_l^{-1} - Kuu_l^{-1} Sq_l Kuu_l^{-1}
  S^{-1} Cov(x,f)_l = sum_m alpha_l[m] eKfu[m, l] (S + Lam_l)^{-1} (z_lm - m)

The cross-covariance comes pre-multiplied by Cov(x,x)^{-1} (preinv=True).

``fused_match`` runs the whole match as one CUDA kernel op
(ops/mm_match_cuda.py). Not ported yet: the diagonal-only path
(``full_output_cov=False`` without a mixing matrix, which raises on the
unfused path).

The GPR rule (``match_gpr``) is the same with the training inputs as the
inducing points and one shared kernel, so its eKuffu is a single symmetric
(X, X) pair; ``fused`` routes it through the pair-grid kernel with R = P
rows, ``fused_match`` runs the GPR whole match (ops/gpr_match_cuda.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.gp import GPR, SVGP, chol_kuu, gpr_cholesky, gpr_predict_f, svgp_predict_f
from ..moments import GaussianMatch, GaussianMoments
from ..ops import kexp
from ..ops.gpr_match_cuda import FusedGPRMatchGrid, build_fused_gpr_match_grid, fused_gpr_match
from ..ops.kexp_cuda import (
    FusedGPRGrid,
    FusedPairGrid,
    build_fused_gpr_grid,
    build_fused_pair_grid,
    ekuffu_contract_fused,
    ekuffu_contract_gpr,
)
from ..ops.linalg import bcho_solve, cholesky_nan
from ..ops.mm_match_cuda import FusedMatchGrid, build_fused_match_grid, fused_svgp_match
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
    match_grid: Optional[FusedMatchGrid] = None  # the whole-match kernel's tensors (K3)


def svgp_match_cache(
    model: SVGP, fused: bool = False, fused_match: bool = False, uncertainty: bool = True
) -> SVGPMatchCache:
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
    match_grid = (
        build_fused_match_grid(model, alpha, qmat, uncertainty=uncertainty) if fused_match else None
    )
    return SVGPMatchCache(
        luu=luu,
        alpha=alpha,
        cct=cct,
        qmat=qmat,
        pairs=None if fused or fused_match else kexp.ekuffu_pair_cache(model.kernel, model.z),
        fused_grid=fused_grid,
        match_grid=match_grid,
    )


class SVGPTransform:
    """Moment-matchable SVGP posterior. ``deterministic=True`` is the PILCO
    kernel-regressor policy: no model uncertainty, the prediction is the
    posterior mean. ``fused=True`` routes the eKuffu pair grid through the
    CUDA contraction kernel (ops/kexp_cuda.py; its plain version on the
    CPU). ``fused_match=True`` runs the whole match as one CUDA kernel op
    (ops/mm_match_cuda.py; supersedes ``fused``). ``frozen=True`` restricts
    its gradients to the state moments: the drift inside a policy update
    (never set it on a transform whose model trains)."""

    def __init__(
        self,
        model: SVGP,
        deterministic: bool = False,
        jitter: float = 0.0,
        fused: bool = False,
        cache: Optional[SVGPMatchCache] = None,
        fused_match: bool = False,
        frozen: bool = False,
    ):
        self.model = model
        self.deterministic = deterministic
        self.jitter = jitter
        self.fused = fused
        self.cache = cache
        self.fused_match = fused_match
        self.frozen = frozen

    def with_cache(self) -> "SVGPTransform":
        cache = svgp_match_cache(
            self.model, fused=self.fused, fused_match=self.fused_match,
            uncertainty=not self.deterministic,
        )
        return SVGPTransform(
            self.model, self.deterministic, self.jitter, self.fused, cache,
            fused_match=self.fused_match, frozen=self.frozen,
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
            jitter=self.jitter, cache=self.cache, frozen=self.frozen,
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
    frozen: bool = False,
) -> GaussianMatch:
    """``full_output_cov=False`` diagonalizes the output covariance after
    mixing; without a mixing matrix the unfused path would take the
    diagonal-only path, which is not ported yet. A cache with a
    ``match_grid`` runs the whole-match kernel op (``frozen`` as in
    ``fused_svgp_match``)."""
    if cache is not None and cache.match_grid is not None:
        grid = cache.match_grid
        if grid.meta.uncertainty != model_uncertainty:
            raise ValueError("fused match grid was built with a different model_uncertainty")
        f1, sff, cross = fused_svgp_match(grid, x.mean, x.cov, frozen=frozen)
        return _mix_and_finish(model, x, f1, sff, cross, jitter, full_output_cov)
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
    return _mix_and_finish(model, x, f1_lat, sff_lat, cross_lat, jitter, full_output_cov)


def _mix_and_finish(model, x, f1_lat, sff_lat, cross_lat, jitter, full_output_cov):
    """Mix the latent moments by ``model.w``, add the mean constant and the
    jitter, and diagonalize when ``full_output_cov`` is off."""
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


# ----------------------------------------------------------------------------
# GPR: the training inputs are the inducing points, one shared kernel
# ----------------------------------------------------------------------------
class GPRMatchCache(NamedTuple):
    """State-independent factors of the GPR moment rule (cf. SVGPMatchCache),
    with a leading member axis for a stacked GPR. ``kyy_inv`` collapses the
    per-step tr(Kyy^{-1} eKuffu) solves to one contraction."""

    lyy: torch.Tensor  # (..., N, N) chol(Knn + noise I)
    alpha: torch.Tensor  # (..., N, P) representer weights
    kyy_inv: torch.Tensor  # (..., N, N)
    pair: Optional[tuple]  # kexp.ekzxxz_pair_terms for (X, X), unfused only
    fused_grid: Optional[FusedGPRGrid] = None  # the pair-grid kernel's tensors (K2)
    match_grid: Optional[FusedGPRMatchGrid] = None  # the GPR whole-match kernel's (K3g)


def gpr_match_cache(
    model: GPR, fused: bool = False, fused_match: bool = False, uncertainty: bool = True
) -> GPRMatchCache:
    lyy = gpr_cholesky(model)
    alpha = bcho_solve(lyy, model.y - model.mean_const[..., None, :])
    eye = torch.eye(lyy.shape[-1], dtype=lyy.dtype, device=lyy.device)
    kyy_inv = bcho_solve(lyy, eye.expand(lyy.shape))
    var, ls = model.kernel.variance, model.kernel.lengthscales
    return GPRMatchCache(
        lyy=lyy,
        alpha=alpha,
        kyy_inv=kyy_inv,
        pair=None if fused or fused_match else kexp.ekzxxz_pair_terms(var, ls, model.x, var, ls, model.x),
        fused_grid=build_fused_gpr_grid(var, ls, model.x, alpha, kyy_inv) if fused else None,
        match_grid=(
            build_fused_gpr_match_grid(model, alpha, kyy_inv, uncertainty=uncertainty)
            if fused_match else None
        ),
    )


class GPRTransform:
    """Moment-matchable GPR posterior. ``fused=True`` routes the (X, X) pair
    grid through the pair-contraction kernel (ops/kexp_cuda.py);
    ``fused_match=True`` runs the whole match as the GPR whole-match kernel
    op (ops/gpr_match_cuda.py), whose backward is frozen (moments only): a
    GPR's hyperparameters train through the LML or HMC, never through the
    match. For a stacked GPR (an ensemble's members) the inputs' last batch
    axis is the member axis: entry k is matched against member k."""

    def __init__(
        self,
        model: GPR,
        deterministic: bool = False,
        jitter: float = 0.0,
        fused: bool = False,
        fused_match: bool = False,
        cache: Optional[GPRMatchCache] = None,
    ):
        self.model = model
        self.deterministic = deterministic
        self.jitter = jitter
        self.fused = fused
        self.fused_match = fused_match
        self.cache = cache

    def with_cache(self) -> "GPRTransform":
        cache = gpr_match_cache(
            self.model, fused=self.fused, fused_match=self.fused_match,
            uncertainty=not self.deterministic,
        )
        return GPRTransform(self.model, self.deterministic, self.jitter, self.fused,
                            self.fused_match, cache)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return gpr_predict_f(self.model, x)[0]

    def moment_match(self, x: GaussianMoments) -> GaussianMatch:
        return match_gpr(
            self.model, x, model_uncertainty=not self.deterministic, jitter=self.jitter,
            cache=self.cache,
        )


def match_gpr(
    model: GPR,
    x: GaussianMoments,
    model_uncertainty: bool = True,
    jitter: float = 0.0,
    cache: Optional[GPRMatchCache] = None,
) -> GaussianMatch:
    """The GPR rule: the SVGP rule with the training inputs as inducing
    points and representer weights alpha = (Knn + noise I)^{-1} (y - mean)."""
    mx, sxx = x.mean, x.cov
    if cache is not None and cache.match_grid is not None:
        grid = cache.match_grid
        if grid.meta.uncertainty != model_uncertainty:
            raise ValueError("fused match grid was built with a different model_uncertainty")
        f1, sff, cross = fused_gpr_match(grid, mx, sxx)
        y = GaussianMoments(mean=f1 + model.mean_const, cov=_add_jitter_diag(sff, jitter))
        return GaussianMatch(x=x, y=y, cross=cross, preinv=True)
    if cache is None:
        cache = gpr_match_cache(model)
    kern, xdata = model.kernel, model.x
    variance = kern.variance
    lam = kern.lengthscales**2  # (..., D)

    # eKfu and the premultiplied cross solve from one Cholesky of S + Lam
    chol = cholesky_nan(sxx + torch.diag_embed(lam))
    il_dx = solve_triangular(chol, (xdata - mx[..., None, :]).mT, lower=True)  # (..., D, N)
    quad = torch.sum(il_dx * il_dx, dim=-2)
    hls = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
    lead = 0.5 * torch.sum(torch.log(lam), -1) - hls
    ekfu = variance[..., None] * torch.exp(lead[..., None] - 0.5 * quad)  # (..., N)
    iv_dx = solve_triangular(chol, il_dx, lower=True, trans=1)  # (..., D, N)
    alpha = cache.alpha

    f1 = torch.einsum("...n,...np->...p", ekfu, alpha)
    if cache.fused_grid is not None:
        f2, ecov_corr = ekuffu_contract_gpr(cache.fused_grid, mx, sxx)
    else:
        ekuffu = kexp.ekzxxz_from_terms(*cache.pair, mx, sxx)  # (..., N, N)
        f2 = torch.einsum("...mp,...mn,...nq->...pq", alpha, ekuffu, alpha)
        ecov_corr = torch.einsum("...mn,...mn->...", cache.kyy_inv, ekuffu) if model_uncertainty else None
    sff = f2 - f1[..., :, None] * f1[..., None, :]
    if model_uncertainty:
        # tr(Kyy^{-1} eKuffu) without per-step (N, N) triangular solves
        eye = torch.eye(sff.shape[-1], dtype=sff.dtype, device=sff.device)
        sff = sff + eye * (variance - ecov_corr)[..., None, None]
    cross = torch.einsum("...np,...n,...dn->...dp", alpha, ekfu, iv_dx)  # (..., D, P)
    y = GaussianMoments(mean=f1 + model.mean_const, cov=_add_jitter_diag(sff, jitter))
    return GaussianMatch(x=x, y=y, cross=cross, preinv=True)
