"""One drift evaluation through the encoder/policy/drift composition
(counterpart of gpflowpilco_tpu/dynamics/forward.py).

``forward_concrete`` evaluates tensors (particle rollouts); ``forward_moments``
composes the encoder, policy and drift matches of GaussianMoments and
rebuilds Cov(x, f) through the composition. Writing e = encoder(x),
u = policy(e), d = (e, u):

    Cov(x, e) is exact from the encoder match (Stein's lemma),
    Cov(x, u) ~= Cov(x, e) Cov(e,e)^{-1} Cov(e, u)            (linearization)
    Cov(x, f) ~= [Cov(x, e), Cov(x, u)] Cov(d,d)^{-1} Cov(d, f)

The joint-PSD guard is ``psd_project`` (eigvalsh); its fused kernel (the TPU
kernel K5a, ``fused_glue``) is not ported yet.
"""
from __future__ import annotations

import torch

from ..moments import GaussianMatch, GaussianMoments, psd_project


def forward_concrete(x, drift, policy=None, encoder=None):
    """drift(concat[e, policy(e)]) with e = encoder(x)."""
    e = x if encoder is None else encoder(x)
    eu = e if policy is None else torch.cat([e, policy(e)], dim=-1)
    return drift(eu)


def forward_moments(x: GaussianMoments, drift, policy=None, encoder=None) -> GaussianMatch:
    """Moment-matched drift evaluation; returns a GaussianMatch from x to f."""
    dx = x.ndim
    if encoder is None and policy is None:
        return drift.moment_match(x)

    if encoder is None:
        # d = (x, u): Cov(x, f) = first Dx rows of Cov(d, f)
        match_policy = policy.moment_match(x)
        match_drift = drift.moment_match(psd_project(match_policy.joint()))
        cross = match_drift.cross_covariance(preinv=False)[..., :dx, :]
        return GaussianMatch(x=x, y=match_drift.y, cross=cross, preinv=False)

    match_encoder = encoder.moment_match(x)
    sxe = match_encoder.cross_covariance(preinv=False)  # (..., Dx, De) exact

    if policy is None:
        # f = drift(e): Cov(x, f) = Cov(x, e) Cov(e,e)^{-1} Cov(e, f)
        match_drift = drift.moment_match(match_encoder.y)
        cross = sxe @ match_drift.cross_covariance(preinv=True)
        return GaussianMatch(x=x, y=match_drift.y, cross=cross, preinv=False)

    # full case: the squash-chain linearization does not guarantee a PSD
    # joint, so project it before the drift match's Cholesky factorizations
    match_policy = policy.moment_match(match_encoder.y)
    match_drift = drift.moment_match(psd_project(match_policy.joint()))
    sxu = sxe @ match_policy.cross_covariance(preinv=True)  # (..., Dx, U)
    sxd = torch.cat([sxe, sxu], dim=-1)  # (..., Dx, De+U)
    sxf = sxd @ match_drift.cross_covariance(preinv=True)  # (..., Dx, F)
    return GaussianMatch(x=x, y=match_drift.y, cross=sxf, preinv=False)
