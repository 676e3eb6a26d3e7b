"""Carry weights across from numpy dicts named after the JAX package's
fields, and back (the loop's checkpoints hold models as such dicts).

Raw (unconstrained) parameters are taken as they are, so gradients in raw
space compare one to one with the JAX package.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .models.gp import GPR, SVGP, GPREnsemble
from .models.kernels import RBF, SharedRBF
from .models.pathwise import PathState


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _svgp_kernel(d: Mapping, device, dtype) -> RBF:
    """The RBF, or with a ``num_outputs`` that is not None the SharedRBF,
    of an SVGP's dict."""
    raw = (_t(d["raw_variance"], device, dtype), _t(d["raw_lengthscales"], device, dtype))
    if d.get("num_outputs") is not None:
        return SharedRBF(*raw, int(d["num_outputs"]), ls_low=d["ls_low"], ls_high=d["ls_high"])
    return RBF(*raw, ls_low=d["ls_low"], ls_high=d["ls_high"])


def svgp_from_numpy(d: Mapping, device, dtype) -> SVGP:
    """An SVGP from ``raw_variance``, ``raw_lengthscales``, ``z``, ``q_mu``,
    ``q_sqrt``, ``mean_const``, ``raw_noise``, ``w`` (array or None),
    ``whiten``, ``ls_low``, ``ls_high`` and, for a shared kernel (the JAX
    package's SharedRBF), ``num_outputs`` (absent or None otherwise)."""
    kernel = _svgp_kernel(d, device, dtype)
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


def _n(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def svgp_to_numpy(model: SVGP) -> dict:
    """The fields ``svgp_from_numpy`` reads."""
    return dict(
        raw_variance=_n(model.kernel.raw_variance),
        raw_lengthscales=_n(model.kernel.raw_lengthscales),
        z=_n(model.z),
        q_mu=_n(model.q_mu),
        q_sqrt=_n(model.q_sqrt),
        mean_const=_n(model.mean_const),
        raw_noise=_n(model.raw_noise),
        w=None if model.w is None else _n(model.w),
        whiten=model.whiten,
        ls_low=model.kernel.ls_low,
        ls_high=model.kernel.ls_high,
        num_outputs=model.kernel.num_outputs if isinstance(model.kernel, SharedRBF) else None,
    )


def gpr_to_numpy(model: GPR) -> dict:
    """The fields ``gpr_from_numpy`` reads (a stacked GPR keeps its member
    axis on the parameters and one copy of the data)."""
    return dict(
        raw_variance=_n(model.kernel.raw_variance),
        raw_lengthscales=_n(model.kernel.raw_lengthscales),
        x=_n(model.x),
        y=_n(model.y),
        mean_const=_n(model.mean_const),
        raw_noise=_n(model.raw_noise),
        ls_low=model.kernel.ls_low,
        ls_high=model.kernel.ls_high,
    )


def gpr_ensemble_to_numpy(model: GPREnsemble) -> dict:
    """The fields ``gpr_ensemble_from_numpy`` reads."""
    return gpr_to_numpy(model.members)


_KINDS = {
    "svgp": (SVGP, svgp_to_numpy, svgp_from_numpy),
    "gpr": (GPR, gpr_to_numpy, gpr_from_numpy),
    "gpr_ensemble": (GPREnsemble, gpr_ensemble_to_numpy, gpr_ensemble_from_numpy),
}


def model_to_numpy(model) -> Optional[dict]:
    """An SVGP, GPR or GPREnsemble as its numpy dict plus its ``kind``;
    None passes through."""
    if model is None:
        return None
    for kind, (cls, to_numpy, _) in _KINDS.items():
        if type(model) is cls:
            return {"kind": kind, **to_numpy(model)}
    raise TypeError(f"no numpy form for a {type(model).__name__}")


def model_from_numpy(d: Optional[Mapping], device, dtype):
    """The model ``model_to_numpy`` wrote; None passes through."""
    if d is None:
        return None
    return _KINDS[d["kind"]][2](d, device, dtype)
