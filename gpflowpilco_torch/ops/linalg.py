"""Small batched linear-algebra helpers (counterpart of gpflowpilco_tpu/ops/linalg.py).

Leading batch dimensions broadcast numpy-style, as in the JAX package.
"""
from __future__ import annotations

import torch


def bsolve_triangular(a, b, lower: bool = True, trans: int = 0):
    """Solve ``a x = b`` (``trans=0``) or ``a^T x = b`` (``trans=1``) for a
    triangular ``a``, broadcasting leading batch dims."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(batch + a.shape[-2:])
    b = b.expand(batch + b.shape[-2:])
    if trans:
        return torch.linalg.solve_triangular(a.mT, b, upper=lower)
    return torch.linalg.solve_triangular(a, b, upper=not lower)


def bcho_solve(chol_lower, b):
    """cho_solve((L, lower=True), b) with broadcasting."""
    y = bsolve_triangular(chol_lower, b, lower=True)
    return bsolve_triangular(chol_lower, y, lower=True, trans=1)


def cholesky_nan(a):
    """``chol(a)`` with NaN factors where the factorization fails, as JAX
    returns them. ``cholesky_ex`` without its error check neither raises nor
    waits for the device, so the per-step D x D factorizations of the moment
    match keep the host free; a NaN loss then makes the guarded Adam skip the
    step, as in the JAX package."""
    chol, info = torch.linalg.cholesky_ex(a)
    return chol.masked_fill((info != 0)[..., None, None], float("nan"))


def safe_cholesky(a, extra_jitter, max_escalations: int = 2, factor: float = 100.0):
    """``chol(a + extra_jitter * I)`` with escalating-jitter retries.

    ``torch.linalg.cholesky`` raises where JAX returns NaN, so this uses
    ``cholesky_ex`` and treats a nonzero ``info`` or a non-finite factor as a
    failure. On failure the whole batch is refactored with the jitter raised
    by ``factor``, up to ``max_escalations`` times, as the JAX version does. A
    factor that still fails comes back as NaN, as it would from JAX.
    """
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)

    def attempt(j):
        chol, info = torch.linalg.cholesky_ex(a + j * eye)
        bad = (info != 0) | ~torch.isfinite(chol).all(dim=(-2, -1))
        return chol, bad

    chol, bad = attempt(extra_jitter)
    for level in range(1, max_escalations + 1):
        if not bool(bad.any()):
            return chol
        chol, bad = attempt(extra_jitter * factor**level)
    return torch.where(bad[..., None, None], torch.full_like(chol, float("nan")), chol)
