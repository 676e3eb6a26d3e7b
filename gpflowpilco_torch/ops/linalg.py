"""Small batched linear-algebra helpers (counterpart of gpflowpilco_tpu/ops/linalg.py).

Leading batch dimensions broadcast numpy-style, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..utils import tracing


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


def _failed(chol, info):
    """Per matrix: the factorization failed (``info``) or left a non-finite factor."""
    return (info != 0) | ~torch.isfinite(chol).all(dim=(-2, -1))


def _escalating_cholesky(a, extra_jitter, max_escalations, factor, entrywise, site):
    """``chol(a + extra_jitter * I)``, retried with the jitter raised by
    ``factor`` up to ``max_escalations`` times while a factor fails; with
    ``entrywise`` only the failing matrices of the batch take the retry,
    else the whole batch does. A factor that still fails comes back as NaN.

    ``torch.linalg.cholesky`` raises where JAX returns NaN, so this uses
    ``cholesky_ex`` and treats a nonzero ``info`` or a non-finite factor as a
    failure. Costs one host synchronization (the ``any`` check) when no
    matrix fails, and one more per escalation level that runs, each counted
    and timed under ``site`` (``tracing.host_sync``)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)

    def attempt(j):
        chol, info = torch.linalg.cholesky_ex(a + j * eye)
        return chol, _failed(chol, info)

    chol, bad = attempt(extra_jitter)
    for level in range(1, max_escalations + 1):
        if not tracing.host_sync(site, bad.any()):
            return chol
        retry, still = attempt(extra_jitter * factor**level)
        if entrywise:
            chol, bad = torch.where(bad[..., None, None], retry, chol), bad & still
        else:
            chol, bad = retry, still
    return torch.where(bad[..., None, None], torch.full_like(chol, float("nan")), chol)


def safe_cholesky(a, extra_jitter, max_escalations: int = 2, factor: float = 100.0,
                  site: str = "chol"):
    """``chol(a + extra_jitter * I)`` with escalating-jitter retries of the
    whole batch when any matrix fails, as the JAX version does unbatched.
    ``site`` names its host syncs."""
    return _escalating_cholesky(a, extra_jitter, max_escalations, factor, False, site)


def safe_cholesky_on_device(a, extra_jitter, max_escalations: int = 2, factor: float = 100.0):
    """``safe_cholesky`` with no host sync, so a CUDA graph can hold it: the
    whole batch escalates when any matrix fails, at most ``max_escalations``
    times by ``factor``, and a matrix whose last attempt fails comes back as
    NaN, as there.

    The attempts below the last level are probed without gradient, and the
    jitter of the first level at which no matrix fails (else the last) is
    picked on the device as a 0-dim tensor; then one differentiable
    factorization runs at it. With no failure the factor and its gradient
    are ``safe_cholesky``'s bit for bit (``a + j_t I`` is ``a + j I``). No
    select between differentiable factors: a failed one's NaN would reach
    the gradient through the branch not taken."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    with torch.no_grad():
        probe = a.detach()
        jitter = torch.full((), extra_jitter * factor**max_escalations, dtype=a.dtype, device=a.device)
        for level in reversed(range(max_escalations)):
            j = extra_jitter * factor**level
            jitter = torch.where(_failed(*torch.linalg.cholesky_ex(probe + j * eye)).any(), jitter, j)
    chol, info = torch.linalg.cholesky_ex(a + jitter * eye)
    return torch.where(_failed(chol, info)[..., None, None], torch.full_like(chol, float("nan")), chol)


def safe_cholesky_entrywise(a, extra_jitter, max_escalations: int = 2, factor: float = 100.0,
                            site: str = "chol"):
    """``safe_cholesky`` with the escalation decided for each matrix of the
    batch on its own, as the JAX version behaves under ``vmap`` (its
    ``lax.cond`` becomes a select per entry): only an entry whose factor
    failed takes the raised jitter, so one chain's or member's tiny noise
    does not change another's factor."""
    return _escalating_cholesky(a, extra_jitter, max_escalations, factor, True, site)
