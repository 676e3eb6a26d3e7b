"""PILCO's signal-to-noise-ratio penalty (counterpart of gpflowpilco_tpu/models/priors.py):
penalty = -sum((log_snr / log_threshold)^power)."""
from __future__ import annotations

import math

import torch

from .gp import SVGP


def log_snr(model) -> torch.Tensor:
    """Per-output log signal-to-noise ratio: (P,) for an SVGP, (..., 1) for
    a GPR, whose single-output kernel gives one ratio per member (the JAX
    package's ``atleast_1d`` of the scalar variance, with any leading member
    or chain axis kept)."""
    log_noise = torch.log(model.noise_variance)
    variance = model.kernel.variance
    if not isinstance(model, SVGP):
        return (torch.log(variance) - log_noise)[..., None]
    if model.w is not None:
        # mixed outputs: the signal per output mixes latent variances through W^2
        return torch.log((model.w**2) @ variance) - log_noise
    return torch.log(torch.atleast_1d(variance)) - log_noise


def pilco_snr_penalty(model, threshold: float = 1e5, power: float = 30.0):
    """() for an SVGP or a GPR, (K,) for a GPR stacked over K members or chains."""
    snr = log_snr(model)
    return -torch.sum((snr / math.log(threshold)) ** power, dim=-1)
