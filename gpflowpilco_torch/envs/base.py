"""Environments as pure state-transition functions
(counterpart of gpflowpilco_tpu/envs/base.py): fixed-step RK4 at a finer
substep than the control interval."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..dynamics.solvers import rk4_integrate


class Box(NamedTuple):
    """Static action/observation bounds."""

    low: tuple
    high: tuple

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        lo = torch.as_tensor(self.low, dtype=x.dtype, device=x.device)
        hi = torch.as_tensor(self.high, dtype=x.dtype, device=x.device)
        return torch.minimum(torch.maximum(x, lo), hi)

    def sample(self, generator: Optional[torch.Generator], shape=(), dtype=None, device=None):
        """Uniform draws of shape ``shape + (len(low),)``."""
        lo = torch.as_tensor(self.low, dtype=dtype, device=device)
        hi = torch.as_tensor(self.high, dtype=dtype, device=device)
        u = torch.rand(
            tuple(shape) + lo.shape, generator=generator, dtype=lo.dtype, device=lo.device
        )
        return lo + (hi - lo) * u


def clip_derivative(deriv, state, low, high):
    """Clip state derivatives so integration cannot leave the observation box."""
    lo = torch.as_tensor(low, dtype=deriv.dtype, device=deriv.device)
    hi = torch.as_tensor(high, dtype=deriv.dtype, device=deriv.device)
    return torch.minimum(torch.maximum(deriv, lo - state), hi - state)


def env_step(env, state, action, dt: float, substeps: int = 10):
    """One control step: clip the action, integrate the ODE for dt with RK4."""
    action = env.action_space.clip(action)
    return rk4_integrate(lambda s: env.ode(s, action), state, dt, substeps)


def rollout(env, policy: Callable, x0: torch.Tensor, dt: float, num_steps: int, substeps: int = 10):
    """Unroll ``num_steps`` control steps from x0 (D,), or from a batch of
    initial states x0 (..., D) at once; policy maps raw states -> actions.
    Returns (states incl. x0: (T+1, ..., D), actions: (T, ..., U))."""
    states, actions = [x0], []
    state = x0
    for _ in range(num_steps):
        action = policy(state)
        state = env_step(env, state, action, dt, substeps)
        states.append(state)
        actions.append(action)
    return torch.stack(states), torch.stack(actions)
