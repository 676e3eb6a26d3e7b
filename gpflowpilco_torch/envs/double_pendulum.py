"""Double pendulum with absolute link angles and a torque at each joint
(counterpart of gpflowpilco_tpu/envs/double_pendulum.py).

4-D state (a0, a1, da0, da1), the angles measured from upright, 2-D torque
in [-2, 2], both links uniform rods of mass 0.5 and length 0.5. The 2 x 2
mass matrix is inverted in closed form:

  A = [[ l0^2 (m0/3 + m1),        0.5 l0 l1 m1 cos(a0-a1) ],
       [ 0.5 l0 l1 m1 cos(a0-a1), l1^2 m1 / 3             ]]
  b0 = f0 - mu0 da0 + l0 [ (0.5 m0 + m1) g sin a0 - 0.5 m1 l1 sin(a0-a1) da1^2 ]
  b1 = f1 - mu1 da1 + l1 [ 0.5 m1 (g sin a1 + l0 sin(a0-a1) da0^2) ]
  [dda0, dda1] = A^{-1} b
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .base import Box


class DoublePendulum:
    state_dim = 4
    action_dim = 2

    def __init__(
        self,
        gravity: float = 9.81,
        mass0: float = 0.5,
        mass1: float = 0.5,
        length0: float = 0.5,
        length1: float = 0.5,
        friction0: float = 0.0,
        friction1: float = 0.0,
        action_space: Box = Box(low=(-2.0, -2.0), high=(2.0, 2.0)),
    ):
        self.gravity = gravity
        self.mass0, self.mass1 = mass0, mass1
        self.length0, self.length1 = length0, length1
        self.friction0, self.friction1 = friction0, friction1
        self.action_space = action_space

    def ode(self, state, action):
        g = self.gravity
        l0, l1 = self.length0, self.length1
        m0, m1 = self.mass0, self.mass1
        a0, a1 = state[..., 0], state[..., 1]
        d_a0, d_a1 = state[..., 2], state[..., 3]
        f0, f1 = action[..., 0], action[..., 1]
        z = a0 - a1
        c, s = torch.cos(z), torch.sin(z)
        a00 = l0**2 * (m0 / 3.0 + m1)
        a01 = 0.5 * l0 * l1 * m1 * c
        a11 = l1**2 * m1 / 3.0
        b0 = f0 - self.friction0 * d_a0 + l0 * (
            (0.5 * m0 + m1) * g * torch.sin(a0) - 0.5 * m1 * l1 * s * d_a1**2
        )
        b1 = f1 - self.friction1 * d_a1 + l1 * (0.5 * m1 * (g * torch.sin(a1) + l0 * s * d_a0**2))
        det = a00 * a11 - a01 * a01
        dd_a0 = (a11 * b0 - a01 * b1) / det
        dd_a1 = (a00 * b1 - a01 * b0) / det
        return torch.stack([d_a0, d_a1, dd_a0, dd_a1], dim=-1)

    def reset(self, generator: Optional[torch.Generator] = None, dtype=None, device=None):
        """Both links hanging, nearly at rest: N([pi, pi, 0, 0], diag(0.01, 0.01, 0.1, 0.1)^2)."""
        loc = torch.tensor([math.pi, math.pi, 0.0, 0.0], dtype=dtype, device=device)
        scale = torch.tensor([0.01, 0.01, 0.1, 0.1], dtype=loc.dtype, device=loc.device)
        return loc + scale * torch.randn(4, generator=generator, dtype=loc.dtype, device=loc.device)

    def get_vertex_coordinates(self, state):
        """((x0, y0), (x1, y1)): the elbow and the outer tip, the pivot at the origin."""
        a0, a1 = state[..., 0], state[..., 1]
        x0 = -self.length0 * torch.sin(a0)
        y0 = self.length0 * torch.cos(a0)
        x1 = x0 - self.length1 * torch.sin(a1)
        y1 = y0 + self.length1 * torch.cos(a1)
        return (x0, y0), (x1, y1)
