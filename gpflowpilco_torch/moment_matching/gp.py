"""Concrete evaluation of an SVGP posterior mean as a transform
(counterpart of ``SVGPTransform`` in gpflowpilco_tpu/moment_matching/gp.py).

The cache holds the input-independent Cholesky factor and representer
weights; the moment-matching fields and ``moment_match`` arrive with
moment-matching PILCO.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.gp import SVGP, chol_kuu, svgp_predict_f
from ..ops.linalg import bcho_solve
from ..ops.linalg import bsolve_triangular as solve_triangular


class SVGPMatchCache(NamedTuple):
    luu: torch.Tensor  # (L, M, M)
    alpha: torch.Tensor  # (L, M) representer weights


def svgp_match_cache(model: SVGP) -> SVGPMatchCache:
    luu = chol_kuu(model)
    q_mu = model.q_mu.T[..., None]  # (L, M, 1)
    if model.whiten:
        alpha = solve_triangular(luu, q_mu, lower=True, trans=1)[..., 0]
    else:
        alpha = bcho_solve(luu, q_mu)[..., 0]
    return SVGPMatchCache(luu=luu, alpha=alpha)


class SVGPTransform:
    """SVGP posterior as a transform. ``deterministic=True`` is the PILCO
    kernel-regressor policy: the prediction is the posterior mean."""

    def __init__(
        self,
        model: SVGP,
        deterministic: bool = False,
        cache: Optional[SVGPMatchCache] = None,
    ):
        self.model = model
        self.deterministic = deterministic
        self.cache = cache

    def with_cache(self) -> "SVGPTransform":
        return SVGPTransform(self.model, self.deterministic, svgp_match_cache(self.model))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.cache is not None:
            # mean from the hoisted representer weights: one gram and one
            # contraction per call instead of a fresh Cholesky and solves
            kxu = self.model.kernel.gram(x[..., None, :, :], self.model.z)  # (..., L, N, M)
            mean_lat = torch.einsum("...lnm,lm->...nl", kxu, self.cache.alpha)
            mean = mean_lat @ self.model.w.T if self.model.w is not None else mean_lat
            return mean + self.model.mean_const
        return svgp_predict_f(self.model, x)[0]
