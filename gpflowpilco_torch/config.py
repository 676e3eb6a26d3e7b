"""Numeric defaults (counterpart of gpflowpilco_tpu/config.py).

Only the Cholesky jitter is carried over: the port takes its dtype from the
caller, so there is no global default float.
"""
from __future__ import annotations

import torch


def default_jitter(dtype=None) -> float:
    """Cholesky jitter. f32 needs ~100x more than the f64 default: at M=256
    inducing points a 1e-6 jitter underflows against f32 rounding in Kuu and
    the factorization fails."""
    if dtype is not None and dtype == torch.float32:
        return 1e-4
    return 1e-6


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names one."""
    return torch.device("cuda" if device is None else device)
