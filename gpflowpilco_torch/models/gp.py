"""Sparse variational GP and exact GPR (counterpart of gpflowpilco_tpu/models/gp.py).

An ``SVGP`` is an ``nn.Module`` whose raw parameters are ``nn.Parameter``s;
the ELBO and predictions are plain functions of it. Latent-stacked layout as
in the JAX package: one RBF with variance (L,) and lengthscales (L, D),
inducing inputs z (L, M, D), q_mu (M, L), q_sqrt (L, M, M), and an optional
(P, L) mixing matrix ``w``.
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import torch
from torch import nn

from .. import config
from ..ops.linalg import bsolve_triangular as solve_triangular
from ..ops.linalg import safe_cholesky, safe_cholesky_entrywise, safe_cholesky_on_device
from ..utils import bijectors as bij
from ..utils import tracing
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
        self.held_kuu = None  # frozen_chol_kuu's factor, with what it was factored from

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


@tracing.span("kuu.factor")
def chol_kuu(model: SVGP, on_device: bool = False) -> torch.Tensor:
    """(L, M, M) Cholesky of the jittered inducing covariances, with
    escalating-jitter retries (host syncs ``sync.kuu``), or with
    ``on_device`` the same retries decided on the device, with no host sync
    (``safe_cholesky_on_device``)."""
    k = model.kernel.gram(model.z)
    if on_device:
        return safe_cholesky_on_device(k, config.default_jitter(model.z.dtype))
    return safe_cholesky(k, config.default_jitter(model.z.dtype), site="kuu")


def frozen_chol_kuu(model: SVGP) -> torch.Tensor:
    """``chol_kuu(model)`` of a model no gradient reaches, factored once per
    version: the model holds its factor while every tensor the factor reads
    (z and the kernel's parameters and buffers) keeps its address and its
    version counter, and factors again, escalation and host syncs as
    ``chol_kuu``'s, once one moves (an in-place refit). The model also holds
    those tensors, so no other tensor takes their addresses. Where a tensor
    of the model requires grad, ``chol_kuu(model)``."""
    if any(t.requires_grad for t in (*model.parameters(), *model.buffers())):
        return chol_kuu(model)
    reads = (model.z, *model.kernel.parameters(), *model.kernel.buffers())
    key = tuple((t.data_ptr(), t._version, t.shape, t.stride(), t.dtype, t.device) for t in reads)
    held = model.held_kuu
    if held is not None and held[0] == key:
        tracing.kuu_cache_event("hits")
        return held[1]
    tracing.kuu_cache_event("misses")
    luu = chol_kuu(model)
    model.held_kuu = (key, luu, tuple(t.detach() for t in reads))
    return luu


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


# ----------------------------------------------------------------------------
# GPR: exact GP, one single-output kernel shared across the output columns
# ----------------------------------------------------------------------------
class GPR(nn.Module):
    """Exact GP regression with a Gaussian likelihood (counterpart of the GPR
    half of gpflowpilco_tpu/models/gp.py).

    The kernel is single-output: variance () and lengthscales (D,). The data
    ``x`` (N, D) and ``y`` (N, P) are buffers, not parameters, so every
    parameter (kernel, ``mean_const`` (P,), ``raw_noise`` ()) is a
    hyperparameter. A *stacked* GPR carries a leading member (or chain)
    axis K on every parameter (variance (K,), lengthscales (K, D),
    mean_const (K, P), raw_noise (K,)) and shares one copy of the data: the
    functions below then work on all K at once, member k against its own
    hyperparameters.
    """

    def __init__(
        self,
        kernel: RBF,
        x: torch.Tensor,
        y: torch.Tensor,
        mean_const: torch.Tensor,
        raw_noise: torch.Tensor,
    ):
        super().__init__()
        self.kernel = kernel
        self.register_buffer("x", x)
        self.register_buffer("y", y)
        self.mean_const = nn.Parameter(mean_const)
        self.raw_noise = nn.Parameter(raw_noise)

    @property
    def noise_variance(self) -> torch.Tensor:
        return bij.positive(self.raw_noise)

    @property
    def stacked(self) -> bool:
        """True when the parameters carry a leading member axis."""
        return self.raw_noise.dim() > 0


class GPREnsemble(nn.Module):
    """A posterior ensemble of GPRs sharing the data, with hyperparameters
    drawn from an HMC posterior: ``members`` is one stacked GPR whose
    parameters carry the member axis K."""

    def __init__(self, members: GPR, num_members: int):
        super().__init__()
        if not members.stacked or members.raw_noise.shape[0] != num_members:
            raise ValueError("GPREnsemble: members must be a GPR stacked over num_members")
        self.members = members
        self.num_members = num_members


def gpr_cholesky(model: GPR) -> torch.Tensor:
    """chol(Knn + noise I) (..., N, N), with the jitter floor and escalating
    retries decided for each member on its own: sampled noise can reach
    ~1e-5 on deterministic-simulator data, leaving Knn + noise I singular in
    float32."""
    x = model.x
    knn = model.kernel.gram(x)
    eye = torch.eye(x.shape[0], dtype=knn.dtype, device=knn.device)
    kyy = knn + model.noise_variance[..., None, None] * eye
    return safe_cholesky_entrywise(kyy, config.default_jitter(knn.dtype), site="kyy")


def gpr_lml(model: GPR) -> torch.Tensor:
    """Log marginal likelihood summed over output columns: () for a GPR,
    (K,) for a stacked one."""
    n, p = model.y.shape
    lyy = gpr_cholesky(model)
    err = model.y - model.mean_const[..., None, :]
    il_err = solve_triangular(lyy, err, lower=True)
    half_logdet = torch.sum(torch.log(torch.diagonal(lyy, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * torch.sum(il_err**2, dim=(-2, -1)) - p * half_logdet - 0.5 * n * p * _LOG2PI


def gpr_predict_f(model: GPR, xs: torch.Tensor, full_cov: bool = False):
    """Posterior at xs (S, D) -> mean (..., S, P) and var (..., S, P) (one
    shared variance per point), or cov (..., S, S) with ``full_cov``."""
    lyy = gpr_cholesky(model)
    kern = model.kernel
    a = solve_triangular(lyy, kern.gram(model.x, xs), lower=True)  # (..., N, S)
    err = model.y - model.mean_const[..., None, :]
    il_err = solve_triangular(lyy, err, lower=True)  # (..., N, P)
    mean = a.mT @ il_err + model.mean_const[..., None, :]
    if full_cov:
        return mean, kern.gram(xs) - a.mT @ a
    var = kern.variance[..., None] - torch.sum(a * a, dim=-2)  # (..., S)
    return mean, var[..., None] * torch.ones_like(mean)


def _split_hypers(model: GPR, flat: torch.Tensor):
    """Cut flat (..., dim) hyperparameter vectors, in ``named_parameters``
    order, into {name: (..., *shape)}."""
    batch = flat.shape[:-1]
    out, k = {}, 0
    for name, p in model.named_parameters():
        n = p.numel()
        out[name] = flat[..., k:k + n].reshape(batch + p.shape)
        k += n
    if k != flat.shape[-1]:
        raise ValueError(f"hyperparameter vector of size {flat.shape[-1]}, the GPR has {k}")
    return out


def gpr_view(model: GPR, flat: torch.Tensor) -> GPR:
    """A view of ``model`` whose hyperparameters are the flat vectors
    (..., dim), in the autograd graph of ``flat``; with a leading axis it is
    a stacked GPR (the HMC chains). The data buffers are shared."""
    vals = _split_hypers(model, flat)
    kernel = copy.copy(model.kernel)  # a new __dict__ holding the same entries
    kernel._parameters = {n: vals[f"kernel.{n}"] for n in model.kernel._parameters}
    view = copy.copy(model)
    view._parameters = {n: vals[n] for n in model._parameters}
    view._modules = {"kernel": kernel}
    return view


def gpr_stack(model: GPR, flat: torch.Tensor) -> GPR:
    """A stacked GPR whose K members' hyperparameters are the rows of flat
    (K, dim) (detached), sharing ``model``'s data and kernel bounds."""
    vals = {n: v.detach().clone() for n, v in _split_hypers(model, flat).items()}
    kern = model.kernel
    return GPR(
        kernel=RBF(vals["kernel.raw_variance"], vals["kernel.raw_lengthscales"],
                   ls_low=kern.ls_low, ls_high=kern.ls_high),
        x=model.x, y=model.y, mean_const=vals["mean_const"], raw_noise=vals["raw_noise"],
    )
