"""Carry weights across from numpy dicts named after the JAX package's fields.

Raw (unconstrained) parameters are taken as they are, so gradients in raw
space compare one to one with the JAX package.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.gp import SVGP
from .models.kernels import RBF
from .models.pathwise import PathState


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def svgp_from_numpy(d: Mapping, device, dtype) -> SVGP:
    """An SVGP from ``raw_variance``, ``raw_lengthscales``, ``z``, ``q_mu``,
    ``q_sqrt``, ``mean_const``, ``raw_noise``, ``w`` (array or None),
    ``whiten``, ``ls_low`` and ``ls_high``."""
    kernel = RBF(
        _t(d["raw_variance"], device, dtype),
        _t(d["raw_lengthscales"], device, dtype),
        ls_low=d["ls_low"],
        ls_high=d["ls_high"],
    )
    w = d.get("w")
    return SVGP(
        kernel=kernel,
        z=_t(d["z"], device, dtype),
        q_mu=_t(d["q_mu"], device, dtype),
        q_sqrt=_t(d["q_sqrt"], device, dtype),
        mean_const=_t(d["mean_const"], device, dtype),
        raw_noise=_t(d["raw_noise"], device, dtype),
        w=None if w is None else _t(w, device, dtype),
        whiten=bool(d["whiten"]),
    )


def paths_from_numpy(d: Mapping, device, dtype) -> PathState:
    """A PathState from ``omega``, ``phase``, ``w`` and ``v``."""
    return PathState(**{k: _t(d[k], device, dtype) for k in ("omega", "phase", "w", "v")})
