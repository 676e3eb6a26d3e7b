"""Trajectory solvers (counterpart of gpflowpilco_tpu/dynamics/solvers.py).

The JAX ``lax.scan`` bodies become Python loops: PyTorch runs eagerly, and
the 30-step horizon is serial either way.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


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
