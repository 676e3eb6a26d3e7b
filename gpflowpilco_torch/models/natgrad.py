"""Natural-gradient updates of an SVGP's q(u) (counterpart of
gpflowpilco_tpu/models/natgrad.py).

For q(u) = N(m, S), step in the natural parameters theta = (S^{-1} m,
-1/2 S^{-1}) along the gradient in the expectation parameters
eta = (m, S + m m^T):

    dL/deta1 = dL/dm - 2 (dL/dS) m
    dL/deta2 = dL/dS
    theta <- theta - gamma * dL/deta, then recover (m, S).

With a Gaussian likelihood the ELBO is conjugate in q, so gamma = 1 jumps to
the exact optimal q(u) in one step. The ELBO is a function of (m, S) with S
dense; its log-determinant comes from S's Cholesky factor, whose autograd
gives a symmetric dL/dS, as the JAX package's slogdet does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.linalg import bcho_solve, bsolve_triangular
from .gp import SVGP, chol_kuu

_LOG2PI = math.log(2.0 * math.pi)


def _elbo_meanvar(
    model: SVGP,
    m: torch.Tensor,
    s: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    num_data: Optional[int] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The ELBO as a function of the variational mean m (L, M) and dense SPD
    covariance s (L, M, M), in the model's (whitened or not) coordinates."""
    luu = chol_kuu(model)  # (L, M, M)
    kxu = model.kernel.gram(x[..., None, :, :], model.z)  # (L, N, M)
    a = bsolve_triangular(luu, kxu.mT, lower=True)  # (L, M, N)
    if model.whiten:
        proj = a
    else:
        # f = Kxu Kuu^{-1} u, with Kuu^{-1} Kux = Luu^{-T} a
        proj = bsolve_triangular(luu, a, lower=True, trans=1)
    mean_lat = torch.einsum("lmn,lm->nl", proj, m)
    quad = torch.einsum("lmn,lmk,lkn->nl", proj, s, proj)
    var_lat = model.kernel.variance[None, :] - torch.einsum("lmn,lmn->nl", a, a) + quad
    if model.w is not None:
        mean = mean_lat @ model.w.T
        var = var_lat @ (model.w**2).T
    else:
        mean, var = mean_lat, var_lat
    mean = mean + model.mean_const

    noise = model.noise_variance
    var_exp = -0.5 * (_LOG2PI + torch.log(noise) + ((y - mean) ** 2 + var) / noise)
    if weights is not None:
        var_exp = var_exp * weights[..., None]
    scale = 1.0 if num_data is None else num_data / x.shape[-2]

    # KL(q || p) in the same coordinates
    # S is SPD: its log-determinant from the Cholesky factor (no pivoted LU)
    logdet_s = 2.0 * torch.sum(torch.log(torch.diagonal(torch.linalg.cholesky(s), dim1=-2, dim2=-1)), dim=-1)
    if model.whiten:
        trace = torch.einsum("lmm->l", s)
        mahal = torch.sum(m * m, dim=-1)
        logdet_p = torch.zeros_like(logdet_s)
    else:
        trace = torch.einsum("lmm->l", bcho_solve(luu, s))
        il_m = bsolve_triangular(luu, m[..., None], lower=True)
        mahal = torch.sum(il_m[..., 0] ** 2, dim=-1)
        logdet_p = 2.0 * torch.sum(torch.log(torch.diagonal(luu, dim1=-2, dim2=-1)), dim=-1)
    kl = 0.5 * torch.sum(trace + mahal - m.shape[-1] + logdet_p - logdet_s)
    return scale * torch.sum(var_exp) - kl


def natgrad_step(
    model: SVGP,
    x: torch.Tensor,
    y: torch.Tensor,
    gamma: float = 1.0,
    num_data: Optional[int] = None,
    weights: Optional[torch.Tensor] = None,
) -> SVGP:
    """One natural-gradient step on (q_mu, q_sqrt), in place; returns the
    model. No gradient reaches the other parameters."""
    with torch.no_grad():
        q_sqrt = torch.tril(model.q_sqrt)  # (L, M, M)
        m0 = model.q_mu.T.contiguous()  # (L, M)
        s0 = q_sqrt @ q_sqrt.mT
    m = m0.clone().requires_grad_(True)
    s = s0.clone().requires_grad_(True)
    loss = -_elbo_meanvar(model, m, s, x, y, num_data, weights)
    dm, ds = torch.autograd.grad(loss, (m, s))
    with torch.no_grad():
        ds = 0.5 * (ds + ds.mT)
        eye = torch.eye(s0.shape[-1], dtype=s0.dtype, device=s0.device).expand(s0.shape)
        chol_s = torch.linalg.cholesky(s0)
        is_m = bcho_solve(chol_s, m0[..., None])[..., 0]  # S^{-1} m
        is_full = bcho_solve(chol_s, eye)
        theta1 = is_m - gamma * (dm - 2.0 * torch.einsum("lmn,ln->lm", ds, m0))
        theta2 = -0.5 * is_full - gamma * ds  # -1/2 S_new^{-1}
        prec_new = -2.0 * theta2
        chol_prec = torch.linalg.cholesky(0.5 * (prec_new + prec_new.mT))
        s_new = bcho_solve(chol_prec, eye)
        s_new = 0.5 * (s_new + s_new.mT)
        m_new = bcho_solve(chol_prec, theta1[..., None])[..., 0]
        model.q_mu.copy_(m_new.T)
        model.q_sqrt.copy_(torch.linalg.cholesky(s_new))
    return model
