"""Headless trajectory rendering of the three environments (counterpart of
gpflowpilco_tpu/envs/render.py): per-state frames, filmstrips of an episode
and animated GIFs, drawn with matplotlib into files. Host-only: states may
be tensors (on any device) or numpy arrays, and nothing here launches work
on the card.

    from gpflowpilco_torch.envs.render import render_trajectory, render_gif
    render_trajectory(env, episode.states, "episode.png")   # filmstrip
    render_gif(env, episode.states, "episode.gif", fps=10)
"""
from __future__ import annotations

import numpy as np
import torch

from .cartpole import CartPole
from .double_pendulum import DoublePendulum
from .mountain_car import MountainCar


def _require_matplotlib():
    import matplotlib

    matplotlib.use("Agg")  # headless backend
    import matplotlib.pyplot as plt

    return plt


def _host(states) -> torch.Tensor:
    """States as a float64 CPU tensor, for the environments' geometry."""
    if isinstance(states, torch.Tensor):
        return states.detach().to("cpu", torch.float64)
    return torch.as_tensor(np.asarray(states), dtype=torch.float64)


# ------------------------------------------------------------------ per-env draw
def _draw_cartpole(ax, env: CartPole, state: torch.Tensor):
    from matplotlib.patches import Rectangle

    x = float(state[0])
    tip_x, tip_y = (float(c) for c in env.get_tip_coordinates(state))
    h = float(env.pole_height)
    cart_w, cart_h = 0.4, 0.2
    ax.axhline(0.0, color="0.2", lw=1)  # track
    ax.add_patch(Rectangle((x - cart_w / 2, -cart_h / 2), cart_w, cart_h, color="0.45", zorder=2))
    ax.plot([x, tip_x], [0.0, tip_y], color="#c8823c", lw=3, zorder=3)
    ax.plot([x], [0.0], "o", color="#8080cc", ms=5, zorder=4)
    ax.plot([0.0], [h], "*", color="green", ms=10, zorder=1)  # goal tip
    lim = max(2.0, abs(x) + 1.0)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-1.0, 1.0)
    ax.set_aspect("equal")


def _draw_mountain_car(ax, env: MountainCar, state: torch.Tensor):
    xs = torch.linspace(-1.8, 1.1, 200, dtype=torch.float64)
    ax.plot(xs.numpy(), env.height(xs).numpy(), color="0.2", lw=1)
    x = state[0]
    ax.plot([float(x)], [float(env.height(x))], "o", color="#c8463c", ms=8)
    goal = torch.tensor(0.6, dtype=torch.float64)
    ax.plot([0.6], [float(env.height(goal))], "*", color="green", ms=12)
    ax.set_xlim(-1.8, 1.1)
    ax.set_aspect("auto")


def _draw_double_pendulum(ax, env: DoublePendulum, state: torch.Tensor):
    (x0, y0), (x1, y1) = env.get_vertex_coordinates(state)
    x0, y0, x1, y1 = map(float, (x0, y0, x1, y1))
    reach = float(env.length0 + env.length1)
    ax.plot([0.0, x0], [0.0, y0], color="#c8823c", lw=3)
    ax.plot([x0, x1], [y0, y1], color="#3c82c8", lw=3)
    ax.plot([0.0, x0], [0.0, y0], "o", color="0.3", ms=4)
    ax.plot([0.0], [reach], "*", color="green", ms=10)
    ax.set_xlim(-1.1 * reach, 1.1 * reach)
    ax.set_ylim(-1.1 * reach, 1.1 * reach)
    ax.set_aspect("equal")


_DRAWERS = [
    (CartPole, _draw_cartpole),
    (MountainCar, _draw_mountain_car),
    (DoublePendulum, _draw_double_pendulum),
]


def _drawer_for(env):
    for cls, fn in _DRAWERS:
        if isinstance(env, cls):
            return fn
    raise TypeError(f"no renderer registered for {type(env).__name__}")


# ------------------------------------------------------------------ public API
def render_frame(env, state, path=None, ax=None, title=None):
    """Draw one state; save to ``path`` if given, else return the figure."""
    plt = _require_matplotlib()
    own = ax is None
    if own:
        fig, ax = plt.subplots(figsize=(4, 3))
    _drawer_for(env)(ax, env, _host(state))
    ax.set_xticks([])
    ax.set_yticks([])
    if title:
        ax.set_title(title, fontsize=9)
    if not own:
        return None
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path
    return fig


def render_trajectory(env, states, path, num_frames: int = 8):
    """Filmstrip: ``num_frames`` evenly spaced states of one episode in a row."""
    plt = _require_matplotlib()
    states = _host(states)
    idx = np.linspace(0, states.shape[0] - 1, num_frames).astype(int)
    fig, axes = plt.subplots(1, num_frames, figsize=(2.2 * num_frames, 2.2))
    for ax, i in zip(np.atleast_1d(axes), idx):
        render_frame(env, states[i], ax=ax, title=f"t={i}")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def render_gif(env, states, path, fps: int = 10, stride: int = 1):
    """Animated GIF of an episode (PIL assembles the matplotlib frames)."""
    import io

    from PIL import Image

    plt = _require_matplotlib()
    states = _host(states)
    frames = []
    for i in range(0, states.shape[0], stride):
        fig, ax = plt.subplots(figsize=(3, 2.4))
        render_frame(env, states[i], ax=ax, title=f"t={i}")
        fig.tight_layout()
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=80)
        plt.close(fig)
        buf.seek(0)
        frames.append(Image.open(buf).convert("P"))
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=int(1000 / fps), loop=0)
    return path
