"""Carry weights across from numpy dicts named after the JAX package's fields.

Raw (unconstrained) parameters are taken as they are, so gradients in raw
space compare one to one with the JAX package.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.gp import GPR, SVGP, GPREnsemble
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


def gpr_from_numpy(d: Mapping, device, dtype) -> GPR:
    """A GPR from ``raw_variance``, ``raw_lengthscales``, ``x``, ``y``,
    ``mean_const``, ``raw_noise``, ``ls_low`` and ``ls_high``. Parameters
    with a leading member axis give a stacked GPR; ``x`` and ``y`` may carry
    that axis too (the JAX package stacks them per member under ``vmap``),
    and then member 0's copy is taken, since all members share the data."""
    x, y = np.asarray(d["x"]), np.asarray(d["y"])
    stacked = np.ndim(d["raw_noise"]) > 0
    if stacked and x.ndim == 3:
        x, y = x[0], y[0]
    kernel = RBF(
        _t(d["raw_variance"], device, dtype),
        _t(d["raw_lengthscales"], device, dtype),
        ls_low=d["ls_low"],
        ls_high=d["ls_high"],
    )
    return GPR(
        kernel=kernel,
        x=_t(x, device, dtype),
        y=_t(y, device, dtype),
        mean_const=_t(d["mean_const"], device, dtype),
        raw_noise=_t(d["raw_noise"], device, dtype),
    )


def gpr_ensemble_from_numpy(d: Mapping, device, dtype) -> GPREnsemble:
    """A GPREnsemble from the fields of its stacked members (see
    ``gpr_from_numpy``)."""
    members = gpr_from_numpy(d, device, dtype)
    return GPREnsemble(members, num_members=members.raw_noise.shape[0])
