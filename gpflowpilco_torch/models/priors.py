"""PILCO's signal-to-noise-ratio penalty (counterpart of gpflowpilco_tpu/models/priors.py):
penalty = -sum((log_snr / log_threshold)^power)."""
from __future__ import annotations

import math

import torch

from .gp import SVGP


def log_snr(model: SVGP) -> torch.Tensor:
    """Per-output log signal-to-noise ratio."""
    log_noise = torch.log(model.noise_variance)
    variance = model.kernel.variance
    if model.w is not None:
        # mixed outputs: the signal per output mixes latent variances through W^2
        return torch.log((model.w**2) @ variance) - log_noise
    return torch.log(torch.atleast_1d(variance)) - log_noise


def pilco_snr_penalty(model: SVGP, threshold: float = 1e5, power: float = 30.0):
    snr = log_snr(model)
    return -torch.sum((snr / math.log(threshold)) ** power)
