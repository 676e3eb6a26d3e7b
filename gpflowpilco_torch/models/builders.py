"""Model construction from data (counterpart of gpflowpilco_tpu/models/builders.py).

The JAX masks become ``requires_grad`` flags: ``dynamics_mask`` and
``policy_mask`` set them on the model and return its trainable parameters.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..utils import bijectors as bij
from .gp import GPR, SVGP
from .initializers import inducing_points_kmeans, lengthscales_median, replace_duplicates
from .kernels import RBF, SharedRBF


def build_svgp(
    x: torch.Tensor,
    y: torch.Tensor,
    num_inducing: int,
    generator: Optional[torch.Generator] = None,
    coregionalize: Optional[bool] = None,
    num_latent: Optional[int] = None,
    max_corr: float = 1.0,
    q_mu: Optional[torch.Tensor] = None,
    noise_variance: float = 1.0,
    per_output_noise: bool = False,
    whiten: bool = True,
    shared_kernel: bool = False,
    pad_inducing_multiple: int = 0,
    ls_low: float = 0.01,
    ls_high: float = 100.0,
) -> SVGP:
    """An SVGP on the device and dtype of ``x``: RBF kernels with
    median-heuristic lengthscales, k-means inducing points and, when
    ``coregionalize`` (the default where ``num_latent`` differs from the
    outputs), a (P, L) mixing matrix ``w``: the identity at P = L, else
    Gaussian rows normalized to unit norm. ``shared_kernel`` ties one
    hyperparameter set across the latents (``SharedRBF``). With
    ``per_output_noise`` the noise is (P,), each output's
    ``noise_variance`` scaled by its target's variance, so no output starts
    under another's noise floor.

    ``pad_inducing_multiple`` > 0 rounds the inducing count up to that
    multiple (capped at ``num_inducing``), so M changes at most a few times
    as the data grow. The slots past the k-means centres take resamples of
    the data jittered by about one lengthscale, which keeps Kuu's columns
    apart."""
    num_data, num_out = y.shape
    if num_latent is None:
        num_latent = num_out
    if coregionalize is None:
        coregionalize = num_out != num_latent
    if not coregionalize and num_out != num_latent:
        raise ValueError(f"{num_latent} latents for {num_out} outputs need coregionalize")
    dtype, device = x.dtype, x.device

    ls = lengthscales_median(x, lower=ls_low, upper=ls_high)  # (D,)
    if shared_kernel:
        kernel = SharedRBF.create_shared(
            torch.ones((), dtype=dtype, device=device), ls, num_outputs=num_latent,
            ls_low=ls_low, ls_high=ls_high,
        )
    else:
        kernel = RBF.create(
            torch.ones((num_latent,), dtype=dtype, device=device),
            ls[None].repeat(num_latent, 1),
            ls_low=ls_low,
            ls_high=ls_high,
        )
    m = min(num_inducing, num_data)
    m_target = m
    if pad_inducing_multiple > 0:
        m_target = min(num_inducing, -(-m // pad_inducing_multiple) * pad_inducing_multiple)
    z0 = inducing_points_kmeans(x, m, generator=generator)
    if m_target > m:
        idx = torch.randint(0, num_data, (m_target - m,), generator=generator, device=device)
        noise = torch.randn((m_target - m, x.shape[-1]), generator=generator, dtype=dtype, device=device)
        z0 = torch.cat([z0, x[idx] + ls * noise], dim=0)
        m = m_target
    if max_corr < 1.0:
        z0 = torch.as_tensor(
            replace_duplicates(z0.cpu().numpy(), 1.0, ls.cpu().numpy(), tol=max_corr),
            dtype=dtype,
            device=device,
        )
    z = z0[None].repeat(num_latent, 1, 1)
    if q_mu is None:
        q_mu = torch.zeros((m, num_latent), dtype=dtype, device=device)
    q_sqrt = torch.eye(m, dtype=dtype, device=device)[None].repeat(num_latent, 1, 1)
    w = None
    if coregionalize:
        if num_out == num_latent:
            w = torch.eye(num_out, dtype=dtype, device=device)
        else:
            w = torch.randn((num_out, num_latent), generator=generator, dtype=dtype, device=device)
            w = w / torch.linalg.norm(w, dim=-1, keepdim=True)
    if per_output_noise:
        noise0 = noise_variance * (y.var(dim=0, correction=0) + 1e-12)
    else:
        noise0 = torch.tensor(noise_variance, dtype=dtype, device=device)
    return SVGP(
        kernel=kernel,
        z=z,
        q_mu=q_mu,
        q_sqrt=q_sqrt,
        mean_const=torch.zeros((num_out,), dtype=dtype, device=device),
        raw_noise=bij.positive_inv(noise0),
        w=w,
        whiten=whiten,
    )


def build_gpr(
    x: torch.Tensor,
    y: torch.Tensor,
    noise_variance: float = 1.0,
    ls_low: float = 0.01,
    ls_high: float = 100.0,
) -> GPR:
    """An exact GPR on the device and dtype of ``x``: unit variance,
    median-heuristic lengthscales, zero mean."""
    dtype, device = x.dtype, x.device
    ls = lengthscales_median(x, lower=ls_low, upper=ls_high)  # (D,)
    return GPR(
        kernel=RBF.create(torch.ones((), dtype=dtype, device=device), ls, ls_low=ls_low, ls_high=ls_high),
        x=x,
        y=y,
        mean_const=torch.zeros((y.shape[-1],), dtype=dtype, device=device),
        raw_noise=bij.positive_inv(torch.tensor(noise_variance, dtype=dtype, device=device)),
    )


def gpr_mask(model: GPR) -> List[torch.nn.Parameter]:
    """Every GPR parameter trains (the kernel, ``mean_const`` and the noise):
    the data are buffers, the JAX package's frozen ``x`` and ``y``."""
    return _set_trainable(model, lambda name: False)


def _set_trainable(model: SVGP, frozen) -> List[torch.nn.Parameter]:
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(not frozen(name))
        if p.requires_grad:
            trainable.append(p)
    return trainable


def dynamics_mask(model: SVGP, freeze_inducing: bool) -> List[torch.nn.Parameter]:
    """Everything trainable, the mixing matrix ``w`` included, except the
    inducing inputs when M >= N."""
    return _set_trainable(model, lambda name: freeze_inducing and name == "z")


def policy_mask(model: SVGP) -> List[torch.nn.Parameter]:
    """Deterministic kernel-regressor policy: freeze q_sqrt, the kernel
    variance, the noise, the mean and the mixing matrix."""
    frozen = ("q_sqrt", "raw_noise", "mean_const", "w", "raw_variance")
    return _set_trainable(model, lambda name: name.split(".")[-1] in frozen)
