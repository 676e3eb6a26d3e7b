"""Elementary transforms (counterpart of gpflowpilco_tpu/moment_matching/rules.py).

Only the concrete ``__call__`` of each transform is ported; the closed-form
``moment_match`` rules arrive with moment-matching PILCO.
"""
from __future__ import annotations

import torch


def sincos(x, dim: int = -1):
    """concat[sin x, cos x]."""
    return torch.cat([torch.sin(x), torch.cos(x)], dim=dim)


class Shift:
    """y = x + c."""

    def __init__(self, shift):
        self.shift = shift

    def __call__(self, x):
        return x + self.shift


class Scale:
    """y = c * x, elementwise."""

    def __init__(self, scale):
        self.scale = scale

    def __call__(self, x):
        return self.scale * x


class SinCos:
    """y = concat[sin x, cos x]."""

    def __call__(self, x):
        return sincos(x)


class Probit:
    """y = Phi(x), the standard-normal CDF, elementwise."""

    def __call__(self, x):
        return torch.special.ndtr(x)


class SquashedProbit:
    """y = scale * (Phi(x) - 0.5): the PILCO policy squash
    Chain(Scale(scale), Shift(-0.5), Probit()) collapsed into one transform."""

    def __init__(self, scale):
        self.scale = scale

    def __call__(self, x):
        return self.scale * (torch.special.ndtr(x) - 0.5)
