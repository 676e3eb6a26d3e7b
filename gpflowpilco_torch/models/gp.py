"""Sparse variational GP (counterpart of the SVGP half of gpflowpilco_tpu/models/gp.py).

An ``SVGP`` is an ``nn.Module`` whose raw parameters are ``nn.Parameter``s;
the ELBO and predictions are plain functions of it. Latent-stacked layout as
in the JAX package: one RBF with variance (L,) and lengthscales (L, D),
inducing inputs z (L, M, D), q_mu (M, L), q_sqrt (L, M, M), and an optional
(P, L) mixing matrix ``w``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import config
from ..ops.linalg import bsolve_triangular as solve_triangular
from ..ops.linalg import safe_cholesky
from ..utils import bijectors as bij
from .kernels import RBF

_LOG2PI = math.log(2.0 * math.pi)


class SVGP(nn.Module):
    """Sparse variational GP with a Gaussian likelihood.

    q(u_l) = N(q_mu[:, l], tril(q_sqrt[l]) tril(q_sqrt[l])^T), whitened by
    default (u = Luu v). ``raw_noise`` is () shared or (P,) per output.
    """

    def __init__(
        self,
        kernel: RBF,
        z: torch.Tensor,
        q_mu: torch.Tensor,
        q_sqrt: torch.Tensor,
        mean_const: torch.Tensor,
        raw_noise: torch.Tensor,
        w: Optional[torch.Tensor] = None,
        whiten: bool = True,
    ):
        super().__init__()
        self.kernel = kernel
        self.z = nn.Parameter(z)
        self.q_mu = nn.Parameter(q_mu)
        self.q_sqrt = nn.Parameter(q_sqrt)
        self.mean_const = nn.Parameter(mean_const)
        self.raw_noise = nn.Parameter(raw_noise)
        self.w = None if w is None else nn.Parameter(w)
        self.whiten = whiten

    @property
    def noise_variance(self) -> torch.Tensor:
        return bij.positive(self.raw_noise)

    @property
    def num_inducing(self) -> int:
        return self.z.shape[1]


def kuu(model: SVGP, jitter: Optional[float] = None) -> torch.Tensor:
    """(L, M, M) inducing covariances with jitter."""
    if jitter is None:
        jitter = config.default_jitter(model.z.dtype)
    k = model.kernel.gram(model.z)
    eye = torch.eye(model.num_inducing, dtype=k.dtype, device=k.device)
    return k + jitter * eye


def chol_kuu(model: SVGP) -> torch.Tensor:
    """(L, M, M) Cholesky of the jittered inducing covariances, with
    escalating-jitter retries."""
    k = model.kernel.gram(model.z)
    return safe_cholesky(k, config.default_jitter(model.z.dtype))


def svgp_predict_f(model: SVGP, x: torch.Tensor, full_output_cov: bool = False):
    """Posterior marginals at x (..., N, D) -> mean (..., N, P), var.

    var is (..., N, P), or (..., N, P, P) with ``full_output_cov``.
    """
    luu = chol_kuu(model)  # (L, M, M)
    kxu = model.kernel.gram(x[..., None, :, :], model.z)  # (..., L, N, M)
    a = solve_triangular(luu, kxu.mT, lower=True)  # (..., L, M, N)

    q_mu = torch.movedim(model.q_mu, -1, 0)[..., None]  # (L, M, 1)
    q_sqrt = torch.tril(model.q_sqrt)  # (L, M, M)
    if model.whiten:
        proj_mu, proj_sqrt = q_mu, q_sqrt
    else:
        proj_mu = solve_triangular(luu, q_mu, lower=True)
        proj_sqrt = solve_triangular(luu, q_sqrt, lower=True)

    mean_lat = torch.einsum("...lmn,lmo->...nl", a, proj_mu)  # (..., N, L)
    sqrt_t_a = torch.einsum("lmk,...lmn->...lkn", proj_sqrt, a)
    var_lat = (
        model.kernel.variance
        - torch.einsum("...lmn,...lmn->...nl", a, a)
        + torch.einsum("...lkn,...lkn->...nl", sqrt_t_a, sqrt_t_a)
    )

    if model.w is not None:
        mean = mean_lat @ model.w.T
        if full_output_cov:
            var = torch.einsum("pl,...nl,ql->...npq", model.w, var_lat, model.w)
        else:
            var = var_lat @ (model.w**2).T
    else:
        mean, var = mean_lat, var_lat
        if full_output_cov:
            var = torch.diag_embed(var)
    return mean + model.mean_const, var


def svgp_elbo(
    model: SVGP,
    x: torch.Tensor,
    y: torch.Tensor,
    num_data: Optional[int] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Evidence lower bound for a Gaussian likelihood. ``weights`` (N,) lets
    callers pad the data with zero-weight rows."""
    mean, var = svgp_predict_f(model, x, full_output_cov=False)
    noise = model.noise_variance
    err = y - mean
    var_exp = -0.5 * (_LOG2PI + torch.log(noise) + (err**2 + var) / noise)
    if weights is not None:
        var_exp = var_exp * weights[..., None]
    scale = 1.0 if num_data is None else num_data / x.shape[-2]
    return scale * torch.sum(var_exp) - kl_qu_pu(model)


def kl_qu_pu(model: SVGP) -> torch.Tensor:
    """KL(q(u) || p(u)) summed over latents."""
    q_sqrt = torch.tril(model.q_sqrt)  # (L, M, M)
    q_mu = torch.movedim(model.q_mu, -1, 0)[..., None]  # (L, M, 1)
    m = model.num_inducing
    diag = torch.diagonal(q_sqrt, dim1=-2, dim2=-1)
    tiny = 1e-300 if diag.dtype == torch.float64 else 1e-36
    log_det_q = torch.sum(torch.log(diag**2 + tiny), dim=-1)

    if model.whiten:
        trace = torch.sum(q_sqrt**2, dim=(-2, -1))
        mahal = torch.sum(q_mu[..., 0] ** 2, dim=-1)
        log_det_p = torch.zeros_like(log_det_q)
    else:
        luu = chol_kuu(model)
        iluu_sqrt = solve_triangular(luu, q_sqrt, lower=True)
        iluu_mu = solve_triangular(luu, q_mu, lower=True)
        trace = torch.sum(iluu_sqrt**2, dim=(-2, -1))
        mahal = torch.sum(iluu_mu[..., 0] ** 2, dim=-1)
        log_det_p = 2.0 * torch.sum(
            torch.log(torch.diagonal(luu, dim1=-2, dim2=-1)), dim=-1
        )
    return 0.5 * torch.sum(trace + mahal - m + log_det_p - log_det_q)
