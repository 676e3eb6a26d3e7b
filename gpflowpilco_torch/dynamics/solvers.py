"""Trajectory solvers (counterpart of gpflowpilco_tpu/dynamics/solvers.py).

The JAX ``lax.scan`` bodies become Python loops: PyTorch runs eagerly, and
the 30-step horizon is serial either way.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..moments import GaussianMoments


def euler_rollout(
    f: Callable,
    x0: torch.Tensor,
    dt: float,
    num_steps: int,
    accumulate: Optional[Callable] = None,
    acc_init=None,
):
    """Fixed-step Euler rollout of dx/dt = f(t, x).

    ``accumulate(t, x, acc)`` folds a statistic over the visited states (the
    expected cost). Returns (final state, acc, states (T, ...)).
    """
    x, acc, xs = x0, acc_init, []
    for i in range(num_steps):
        t = dt * (1.0 + i)
        x = x + dt * f(t, x)
        if accumulate is not None:
            acc = accumulate(t, x, acc)
        xs.append(x)
    return x, acc, torch.stack(xs)


def moment_matching_euler_rollout(
    forward: Callable,
    x0: GaussianMoments,
    dt: float,
    num_steps: int,
    noise: Optional[Callable] = None,
    cov_jitter: Optional[float] = None,
):
    """Propagate (mean, cov) through ``num_steps`` moment-matched Euler steps:

        m' = m + dt E[f],   S' = S + dt (Sxf + Sxf^T) + dt^2 Sff   (+ noise)

    ``forward(t, x)`` returns the drift's GaussianMatch; ``noise(t, x)``
    (optional) returns the diffusion match, adding sqrt(dt)(Sxz + Szx) +
    dt Szz. The carry is re-symmetrized each step and, when ``cov_jitter``
    is nonzero (default 1e-6 in float32, 0 otherwise), boosted by a
    stop-gradient eigenvalue shift that keeps it positive definite: the
    linearized cross term can leave it indefinite, which in float32
    cascades into failed factorizations. The fused update (the TPU kernel
    K5b) is not ported yet.
    Returns (final GaussianMoments, per-step means, per-step covs).
    """
    mean, cov = x0.mean, x0.cov
    if cov_jitter is None:
        cov_jitter = 1e-6 if mean.dtype == torch.float32 else 0.0
    means, covs = [], []
    for i in range(num_steps):
        t = dt * (1.0 + i)
        x = GaussianMoments(mean=mean, cov=cov)
        match = forward(t, x)
        sxf = match.cross_covariance(preinv=False)
        new_mean = mean + dt * match.y.mean
        new_cov = cov + dt * (sxf + sxf.mT) + (dt**2) * match.y.cov
        if noise is not None:
            match_noise = noise(t, x)
            sxz = match_noise.cross_covariance(preinv=False)
            new_cov = new_cov + math.sqrt(dt) * (sxz + sxz.mT) + dt * match_noise.y.cov
        new_cov = 0.5 * (new_cov + new_cov.mT)
        if cov_jitter:
            lam_min = torch.linalg.eigvalsh(new_cov.detach()).amin(dim=-1)
            boost = torch.clamp(-lam_min, min=0.0) + cov_jitter
            eye = torch.eye(new_cov.shape[-1], dtype=new_cov.dtype, device=new_cov.device)
            new_cov = new_cov + boost[..., None, None] * eye
        mean, cov = new_mean, new_cov
        means.append(mean)
        covs.append(cov)
    return GaussianMoments(mean=mean, cov=cov), torch.stack(means), torch.stack(covs)


def rk4_step(f: Callable, x: torch.Tensor, dt: float) -> torch.Tensor:
    """Classic fourth-order Runge-Kutta step for time-invariant dynamics."""
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return (x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)).to(x.dtype)


def rk4_integrate(f: Callable, x: torch.Tensor, dt_total: float, substeps: int):
    """Integrate dx/dt = f(x) over dt_total with fixed RK4 substeps."""
    h = dt_total / substeps
    for _ in range(substeps):
        x = rk4_step(f, x, h)
    return x
