"""The MM rollout step's PSD guard and Euler moment update as CUDA kernel
ops (counterpart of gpflowpilco_tpu/ops/mm_glue_pallas.py).

    fused_psd_boost(S, jitter)   = sym(S) + (max(0, -lambda_min) + jitter) I
    fused_euler_update(m, S, f1, Sff, Sxf, dt, jitter)
        = (m + dt f1, sym(S + dt (Sxf + Sxf^T) + dt^2 Sff) + boost I)

lambda_min comes from five cyclic Jacobi sweeps (``jacobi_min_eig``), in
place of ``eigvalsh``; ``jitter == 0`` in the Euler update symmetrizes
only, the float64 semantics of the solver. The kernels sweep the pairs in
the round-robin order of ``jacobi_rounds`` for D <= 8 (rounds of disjoint
pairs, whose angles are independent), so kernel and plain version agree to
rounding once five sweeps have converged. The boost is stop-gradient, so
the backwards are the plain formulas of the JAX package's custom VJPs: the
symmetrization passthrough and the linear Euler adjoints.

Dispatch is by the device of the tensors: CUDA tensors go to the kernels of
``csrc/mm_glue.cu`` (float32 or float64, contiguous, D <= 16, else the
wrapper raises), CPU tensors to the plain versions below. There is no
fallback from one to the other. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from . import _build

# kernel launches per entry; reset with reset_launches()
launches = tracing.register_launches(
    {f"{kind}_{sfx}": 0 for kind in ("psd_boost", "euler_update") for sfx in ("f32", "f64")})

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
MAX_D = 16  # the kernels' largest register capacity (csrc/mm_glue.cu)
_SWEEPS = 5


def reset_launches():
    for k in launches:
        launches[k] = 0


def operand_dim(name: str, mats, vecs=()) -> int:
    """D of (N, D, D) matrices and (N, D) vectors; raises ValueError unless
    every operand has those shapes with D <= 16, and TypeError unless all
    share one float32 or float64 dtype."""
    n, d = mats[0].shape[0], mats[0].shape[-1]
    for t in mats:
        if tuple(t.shape) != (n, d, d):
            raise ValueError(f"{name}: matrix of shape {tuple(t.shape)}, expected {(n, d, d)}")
    for t in vecs:
        if tuple(t.shape) != (n, d):
            raise ValueError(f"{name}: vector of shape {tuple(t.shape)}, expected {(n, d)}")
    if d > MAX_D:
        raise ValueError(f"{name}: the kernels take D <= {MAX_D}, got D={d}")
    dtypes = {t.dtype for t in (*mats, *vecs)}
    if len(dtypes) != 1 or mats[0].dtype not in _SUFFIX:
        raise TypeError(f"{name}: operands must share float32 or float64, got {dtypes}")
    return d


# ----------------------------------------------------------------- plain torch
def jacobi_rounds(d: int):
    """The kernels' order of a Jacobi sweep for D <= 8 (csrc/mm_glue.cu,
    rr_p and rr_q): the round-robin (circle) schedule of n = D rounded up to
    even players, round r < n - 1 pairing r with n - 1 and (r + k) mod (n -
    1) with (r - k) mod (n - 1) for k = 1 .. n/2 - 1, a pair holding player
    D (odd D) skipped. A list of rounds, each a list of (p, q), p < q."""
    n = d + d % 2
    rounds = []
    for r in range(n - 1):
        pairs = [(r, n - 1)] + [((r + k) % (n - 1), (r - k) % (n - 1)) for k in range(1, n // 2)]
        rounds.append([(min(a, b), max(a, b)) for a, b in pairs if max(a, b) < d])
    return rounds


def jacobi_min_eig(sym: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue of each symmetric (N, D, D) matrix by five cyclic
    Jacobi sweeps with the Golub-Van Loan tangent, in the kernel's order
    (mm_glue_pallas._jacobi_min_eig)."""
    d = sym.shape[-1]
    a = [[sym[:, i, j] for j in range(d)] for i in range(d)]
    one = torch.ones_like(a[0][0])
    for _ in range(_SWEEPS):
        for p in range(d - 1):
            for q in range(p + 1, d):
                apq, app, aqq = a[p][q], a[p][p], a[q][q]
                h = aqq - app
                sgn = torch.where(h < 0, -one, one)
                denom = torch.abs(h) + torch.sqrt(h * h + 4.0 * apq * apq) + 1e-37
                t = 2.0 * apq * sgn / denom
                c = torch.rsqrt(1.0 + t * t)
                s = t * c
                a[p][p] = c * c * app - 2.0 * s * c * apq + s * s * aqq
                a[q][q] = s * s * app + 2.0 * s * c * apq + c * c * aqq
                a[p][q] = a[q][p] = torch.zeros_like(apq)
                for r in range(d):
                    if r in (p, q):
                        continue
                    arp, arq = a[r][p], a[r][q]
                    a[r][p] = a[p][r] = c * arp - s * arq
                    a[r][q] = a[q][r] = s * arp + c * arq
    lam = a[0][0]
    for i in range(1, d):
        lam = torch.minimum(lam, a[i][i])
    return lam


def _boost(sym, jitter):
    lam = jacobi_min_eig(sym)
    boost = torch.clamp(-lam, min=0.0) + jitter
    eye = torch.eye(sym.shape[-1], dtype=sym.dtype, device=sym.device)
    return sym + boost[:, None, None] * eye


def psd_boost_reference(s, jitter: float):
    """Plain torch: sym(S) + (max(0, -lambda_min) + jitter) I, (N, D, D)."""
    return _boost(0.5 * (s + s.mT), jitter)


def boosted_reference(sym, jitter: float, tol: float):
    """What the kernels give for symmetric (N, D, D) ``sym``, to rounding:
    sym + (max(0, -lambda_min) + jitter) I, lambda_min from
    ``jacobi_min_eig`` where its five cyclic sweeps have converged (within
    tol / 2 of each matrix's scale, 1 + max |sym|, from eigvalsh) or D > 8,
    else from eigvalsh. The kernels sweep D <= 8 in ``jacobi_rounds``'
    order, so they agree with the cyclic sweeps only where both have
    converged. For holding the kernels at a bar ``tol`` of the scale."""
    cyclic = jacobi_min_eig(sym)
    truth = torch.linalg.eigvalsh(sym.double())[:, 0].to(sym.dtype)
    converged = (cyclic - truth).abs() <= 0.5 * tol * (1.0 + sym.abs().amax(dim=(-2, -1)))
    lam = torch.where(converged | (sym.shape[-1] > 8), cyclic, truth)
    eye = torch.eye(sym.shape[-1], dtype=sym.dtype, device=sym.device)
    return sym + (torch.clamp(-lam, min=0.0) + jitter)[:, None, None] * eye


def euler_update_reference(m, s, f1, sff, sxf, dt: float, jitter: float):
    """Plain torch Euler moment update; ``jitter == 0`` symmetrizes only."""
    nm = m + dt * f1
    full = s + (dt * (sxf + sxf.mT) + (dt * dt) * sff)
    sym = 0.5 * (full + full.mT)
    return nm, (_boost(sym, jitter) if jitter else sym)


# ----------------------------------------------------------------- dispatch
def _psd(s, jitter: float):
    d = operand_dim("psd_boost", (s,))
    if s.device.type == "cpu":
        return psd_boost_reference(s, jitter)
    name = f"psd_boost_{_SUFFIX[s.dtype]}"
    out = torch.empty_like(s)
    _build.launch("mm_glue", name, (s, out), ctypes.c_int(s.shape[0]), ctypes.c_int(d),
                  ctypes.c_double(jitter))
    launches[name] += 1
    return out


def _euler(m, s, f1, sff, sxf, dt: float, jitter: float):
    d = operand_dim("euler_update", (s, sff, sxf), (m, f1))
    if s.device.type == "cpu":
        return euler_update_reference(m, s, f1, sff, sxf, dt, jitter)
    name = f"euler_update_{_SUFFIX[s.dtype]}"
    nm, nc = torch.empty_like(m), torch.empty_like(s)
    _build.launch("mm_glue", name, (m, s, f1, sff, sxf, nm, nc), ctypes.c_int(s.shape[0]),
                  ctypes.c_int(d), ctypes.c_double(dt), ctypes.c_double(jitter))
    launches[name] += 1
    return nm, nc


class FusedPsdBoost(torch.autograd.Function):
    """sym(S) + stop-gradient boost; the gradient is the symmetrization's."""

    @staticmethod
    def forward(ctx, s, jitter):
        return _psd(s, jitter)

    @staticmethod
    def backward(ctx, g):
        return 0.5 * (g + g.mT), None


class FusedEulerUpdate(torch.autograd.Function):
    """(new_mean, new_cov) from (m, S, f1, Sff, Sxf); the adjoints are linear."""

    @staticmethod
    def forward(ctx, m, s, f1, sff, sxf, dt, jitter):
        ctx.dt = dt
        return _euler(m, s, f1, sff, sxf, dt, jitter)

    @staticmethod
    def backward(ctx, dnm, dnc):
        dt = ctx.dt
        g = 0.5 * (dnc + dnc.mT)
        return dnm, g, dt * dnm, (dt * dt) * g, 2.0 * dt * g, None, None


def fused_psd_boost(sxx, jitter: float = 0.0):
    """moments.psd_project as one kernel: sxx (..., D, D) -> (..., D, D)."""
    d = sxx.shape[-1]
    out = FusedPsdBoost.apply(sxx.reshape(-1, d, d).contiguous(), float(jitter))
    return out.reshape(sxx.shape)


def fused_euler_update(mean, cov, f1, sff, sxf, dt: float, jitter: float):
    """One moment-matched Euler step fused: mean, f1 (..., D); cov, sff, sxf
    (..., D, D) -> (new_mean, new_cov). ``jitter == 0`` symmetrizes only."""
    d = mean.shape[-1]
    vec = lambda a: a.reshape(-1, d).contiguous()  # noqa: E731
    mat = lambda a: a.reshape(-1, d, d).contiguous()  # noqa: E731
    nm, nc = FusedEulerUpdate.apply(
        vec(mean), mat(cov), vec(f1), mat(sff), mat(sxf), float(dt), float(jitter)
    )
    return nm.reshape(mean.shape), nc.reshape(cov.shape)
