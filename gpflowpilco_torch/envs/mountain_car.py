"""Mountain car with a continuous force (counterpart of
gpflowpilco_tpu/envs/mountain_car.py).

2-D state (x, dx), force in [-4, 4], car mass 1.0, on the height curve

    h(x) = x + x^2 + 0.5             (x < 0)
           x / sqrt(1 + 5 x^2) + 0.5 (x >= 0)

with the equation of motion of a point mass held to the curve:
    ddx = (f / m) / sqrt(s^2 + 1) - g s / (s^2 + 1),  s = h'(x).
The position stays in [-1.5, 1.5] by clipping the derivative.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .base import Box, clip_derivative


class MountainCar:
    state_dim = 2
    action_dim = 1
    obs_low = (-1.5, -math.inf)
    obs_high = (1.5, math.inf)

    def __init__(
        self,
        gravity: float = 9.81,
        mass: float = 1.0,
        action_space: Box = Box(low=(-4.0,), high=(4.0,)),
    ):
        self.gravity = gravity
        self.mass = mass
        self.action_space = action_space

    def height(self, x):
        return torch.where(x < 0, x + x**2, x * torch.rsqrt(1.0 + 5.0 * x**2)) + 0.5

    def slope(self, x):
        return torch.where(x < 0, 1.0 + 2.0 * x, (1.0 + 5.0 * x**2) ** -1.5)

    def ode(self, state, action):
        x, d_x = state[..., 0], state[..., 1]
        f = action[..., 0]
        s = self.slope(x)
        inv = 1.0 / (s**2 + 1.0)
        dd_x = (f / self.mass) * torch.sqrt(inv) - self.gravity * s * inv
        deriv = torch.stack([d_x, dd_x], dim=-1)
        return clip_derivative(deriv, state, (self.obs_low[0], -1e30), (self.obs_high[0], 1e30))

    def reset(self, generator: Optional[torch.Generator] = None, dtype=None, device=None):
        """x ~ U[-0.6, -0.4], at rest."""
        x0 = -0.6 + 0.2 * torch.rand((), generator=generator, dtype=dtype, device=device)
        return torch.stack([x0, torch.zeros_like(x0)])
