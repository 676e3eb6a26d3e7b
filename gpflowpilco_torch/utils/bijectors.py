"""Parameter constraint bijectors (counterpart of gpflowpilco_tpu/utils/bijectors.py).

Raw (unconstrained) parameters are the ``nn.Parameter``s; constrained values
are computed on read, so gradients in raw space compare one to one with the
JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus_inv(y):
    # log(exp(y) - 1), stable: y + log1p(-exp(-y))
    return y + torch.log(-torch.expm1(-y))


def positive(raw, lower: float = 1e-6):
    return F.softplus(raw) + lower


def positive_inv(value, lower: float = 1e-6):
    return softplus_inv(torch.clamp(value - lower, min=1e-12))


def sigmoid_interval(raw, low: float, high: float):
    return low + (high - low) * torch.reciprocal(1.0 + torch.exp(-raw))


def sigmoid_interval_inv(value, low: float, high: float):
    p = (value - low) / (high - low)
    p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
    return torch.log(p) - torch.log1p(-p)
