"""Equations of motion of the configurations' tasks, which the cell's drift
is fitted to in closed form (``inputs.py``): one control step is ``substeps``
RK4 steps of the ODE, as the real episodes are made.

- ``cartpole``: the cart-pole of the PILCO papers (cart and pole masses,
  pole half-length ``height``, cart friction), state (x, theta, dx, dtheta),
  force u;
- ``double_pendulum``: two uniform links with torques at both joints, state
  (a0, a1, da0, da1), absolute angles from upright.
"""
from __future__ import annotations

import torch


def cartpole(p: dict, state, action):
    g, h, m, big_m = p["gravity"], p["height"], p["pole_mass"], p["cart_mass"]
    d_x, d_a, f = state[..., 2], state[..., 3], action[..., 0]
    s, c = torch.sin(state[..., 1]), torch.cos(state[..., 1])
    drag = -p["friction"] * d_x
    dd_x = (f + drag + 0.5 * s * m * (h * d_a**2 + 1.5 * g * c)) / ((big_m + m) - 0.75 * m * c**2)
    dd_a = (c * (f + drag + 0.5 * s * m * h * d_a**2) + (big_m + m) * g * s) / (
        (2.0 / 3.0) * h * (big_m + m) - 0.5 * m * h * c**2)
    return torch.stack([d_x, d_a, dd_x, dd_a], dim=-1)


def double_pendulum(p: dict, state, action):
    g, (l0, l1), (m0, m1) = p["gravity"], p["lengths"], p["masses"]
    a0, a1, d_a0, d_a1 = state.unbind(-1)
    z = a0 - a1
    c, s = torch.cos(z), torch.sin(z)
    a00, a01, a11 = l0**2 * (m0 / 3.0 + m1), 0.5 * l0 * l1 * m1 * c, l1**2 * m1 / 3.0
    b0 = action[..., 0] + l0 * ((0.5 * m0 + m1) * g * torch.sin(a0) - 0.5 * m1 * l1 * s * d_a1**2)
    b1 = action[..., 1] + l1 * (0.5 * m1 * (g * torch.sin(a1) + l0 * s * d_a0**2))
    det = a00 * a11 - a01 * a01
    return torch.stack([d_a0, d_a1, (a11 * b0 - a01 * b1) / det, (a00 * b1 - a01 * b0) / det], dim=-1)


ODES = {"cartpole": cartpole, "double_pendulum": double_pendulum}


def deltas(spec: dict, state, action, dt: float):
    """x_{t+1} - x_t of one control step of ``dt``."""
    ode = ODES[spec["model"]]
    h = dt / spec["substeps"]
    x = state
    for _ in range(spec["substeps"]):
        k1 = ode(spec, x, action)
        k2 = ode(spec, x + 0.5 * h * k1, action)
        k3 = ode(spec, x + 0.5 * h * k2, action)
        k4 = ode(spec, x + h * k3, action)
        x = x + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return x - state
