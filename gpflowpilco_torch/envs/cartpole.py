"""Cart-pole swing-up (counterpart of gpflowpilco_tpu/envs/cartpole.py).

4-D state (x, theta, dx, dtheta), 1-D force in [-10, 10], cart m=0.5
friction=0.1, pole m=0.5 length=0.5, pole modelled as a uniform rod:

  ddx = [f - b dx + 0.5 m s (h w^2 + 1.5 g c)] / [(M + m) - 0.75 m c^2]
  dda = [c (f - b dx + 0.5 m s h w^2) + (M + m) g s]
        / [(2/3) h (M + m) - 0.5 m h c^2]
"""
from __future__ import annotations

import torch

from .base import Box


class CartPole:
    state_dim = 4
    action_dim = 1

    def __init__(
        self,
        gravity: float = 9.81,
        cart_mass: float = 0.5,
        cart_friction: float = 0.1,
        pole_mass: float = 0.5,
        pole_height: float = 0.5,
        action_space: Box = Box(low=(-10.0,), high=(10.0,)),
    ):
        self.gravity = gravity
        self.cart_mass = cart_mass
        self.cart_friction = cart_friction
        self.pole_mass = pole_mass
        self.pole_height = pole_height
        self.action_space = action_space

    def ode(self, state, action):
        g, h, m, big_m = self.gravity, self.pole_height, self.pole_mass, self.cart_mass
        d_x, d_a = state[..., 2], state[..., 3]
        f = action[..., 0]
        s = torch.sin(state[..., 1])
        c = torch.cos(state[..., 1])
        drag = -self.cart_friction * d_x
        dd_x = (f + drag + 0.5 * s * m * (h * d_a**2 + 1.5 * g * c)) / (
            (big_m + m) - 0.75 * m * c**2
        )
        dd_a = (c * (f + drag + 0.5 * s * m * h * d_a**2) + (big_m + m) * g * s) / (
            (2.0 / 3.0) * h * (big_m + m) - 0.5 * m * h * c**2
        )
        return torch.stack([d_x, d_a, dd_x, dd_a], dim=-1)

    def get_tip_coordinates(self, states):
        """Cartesian pole-tip coordinates."""
        x = states[..., 0] - self.pole_height * torch.sin(states[..., 1])
        y = self.pole_height * torch.cos(states[..., 1])
        return x, y
