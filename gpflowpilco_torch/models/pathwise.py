"""Pathwise (decoupled) GP sampling: RFF prior + canonical inducing update
(counterpart of gpflowpilco_tpu/models/pathwise.py), for SVGPs and, with
the training inputs in place of the inducing points, exact GPRs.

  prior   f_s(x) ~= sqrt(2 sigma^2 / B) * sum_b w_sb cos(omega_b . x + phi_b),
            omega_b ~ N(0, diag(1/lengthscales^2)), phi_b ~ U[0, 2pi), w_sb ~ N(0,1)
  update  f_s(x) += k(x, Z) v_s,   v_s = Kuu^{-1} (u_s - f_s(Z)),  u_s ~ q(u)

Sampling is split in two so that tests can feed the JAX package's draws:
``draw_path_noise`` draws the standard normals, the phases, ``w`` and
``eps`` from a ``torch.Generator``; ``paths_from_noise`` turns given noise
into a ``PathState``: for a drift no gradient reaches, from its Kuu factor
taken once per version (``gp.frozen_chol_kuu``) and, on the card, replayed
from one CUDA graph (ops/graphs.py:replayed); the draws stay eager.
``fused_rollout_operands`` packs a policy, a drift and its paths into the
operands of the whole-rollout kernel op (ops/rollout_cuda.py);
``pathwise_rollout_loss_fused`` runs the packing and the op as two CUDA
graphs on the card (ops/graphs.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import graphs
from ..ops.linalg import bcho_solve
from ..ops.linalg import bsolve_triangular as solve_triangular
from ..ops.path_eval_cuda import eval_fused_operands, fused_operands
from ..ops.rollout_cuda import FusedRolloutLoss, RolloutMeta
from ..utils import tracing
from .gp import GPR, SVGP, chol_kuu, frozen_chol_kuu, gpr_cholesky
from .kernels import RBF


class PathState(NamedTuple):
    """A batch of S sampled posterior functions (for one latent-stacked model)."""

    omega: torch.Tensor  # (L, B, D) RFF frequencies
    phase: torch.Tensor  # (L, B)
    w: torch.Tensor  # (S, L, B) prior basis weights
    v: torch.Tensor  # (S, L, M) canonical update weights


class PathNoise(NamedTuple):
    """The random draws behind a PathState."""

    omega_normal: torch.Tensor  # (L, B, D) standard normals
    phase: torch.Tensor  # (L, B) uniform on [0, 2 pi)
    w: torch.Tensor  # (S, L, B) standard normals
    eps: torch.Tensor  # (S, L, M) standard normals for u ~ q(u)


def _prior_at(kernel: RBF, omega, phase, w, x, num_bases: Optional[int] = None):
    """Prior sample values at per-sample inputs x (S, D) -> (S, L). The
    scale is that of ``num_bases`` bases (default: omega's), so that a slab
    of the basis axis gives its part of the whole sum."""
    proj = torch.einsum("sd,lbd->slb", x, omega) + phase
    scale = torch.sqrt(2.0 * kernel.variance / (num_bases or omega.shape[-2]))
    return torch.einsum("slb,slb->sl", scale[:, None] * torch.cos(proj), w)


def _prior_at_shared(kernel: RBF, omega, phase, w, z):
    """Prior sample values at shared inputs z (L, M, D) -> (S, L, M)."""
    proj = torch.einsum("lmd,lbd->lmb", z, omega) + phase[:, None, :]
    scale = torch.sqrt(2.0 * kernel.variance / omega.shape[-2])
    feats = scale[:, None, None] * torch.cos(proj)  # (L, M, B)
    return torch.einsum("lmb,slb->slm", feats, w)


@tracing.span("paths.draw")
def draw_path_noise(
    model: SVGP, num_samples: int, num_bases: int, generator: Optional[torch.Generator] = None
) -> PathNoise:
    """The draws for ``num_samples`` paths of ``model``, on its device and dtype."""
    num_latent, m, d = model.z.shape
    kw = dict(dtype=model.z.dtype, device=model.z.device, generator=generator)
    return PathNoise(
        omega_normal=torch.randn((num_latent, num_bases, d), **kw),
        phase=2.0 * math.pi * torch.rand((num_latent, num_bases), **kw),
        w=torch.randn((num_samples, num_latent, num_bases), **kw),
        eps=torch.randn((num_samples, num_latent, m), **kw),
    )


def _condition(model: SVGP, luu, omega_normal, phase, w, eps):
    """(omega, v) of the paths from the draws, given Kuu's factor ``luu``."""
    kern = model.kernel
    omega = omega_normal / kern.lengthscales[:, None, :]
    q_sqrt = torch.tril(model.q_sqrt)  # (L, M, M)
    v_sample = model.q_mu.T + torch.einsum("lmn,sln->slm", q_sqrt, eps)
    u_sample = torch.einsum("lmn,sln->slm", luu, v_sample) if model.whiten else v_sample
    resid = u_sample - _prior_at_shared(kern, omega, phase, w, model.z)
    # one batched solve per latent with S right-hand sides
    v = torch.movedim(bcho_solve(luu, torch.movedim(resid, 0, -1)), -1, 0)
    return omega, v


@tracing.span("paths.condition")
def paths_from_noise(model: SVGP, noise: PathNoise) -> PathState:
    """Decoupled posterior sample functions of ``model`` from given draws.
    Where no tensor of ``model`` requires grad, Kuu's factor is reused across
    calls, and on the card the conditioning replays from a CUDA graph that
    reads the factor and the model in place."""
    luu = frozen_chol_kuu(model)
    kern = model.kernel
    consts = (model.whiten, (kern.ls_low, kern.ls_high), getattr(kern, "num_outputs", None))
    omega, v = graphs.replayed(lambda *draws: _condition(model, luu, *draws), noise,
                               (*model.parameters(), *model.buffers(), luu), consts)
    return PathState(omega=omega, phase=noise.phase, w=noise.w, v=v)


def generate_paths_svgp(
    model: SVGP, generator: Optional[torch.Generator], num_samples: int, num_bases: int
) -> PathState:
    """Draw S decoupled posterior sample functions."""
    return paths_from_noise(model, draw_path_noise(model, num_samples, num_bases, generator))


def eval_paths_svgp(model: SVGP, paths: PathState, x: torch.Tensor) -> torch.Tensor:
    """Evaluate sample s at its own input x[s]: x (S, D) -> (S, P). Plain
    torch, differentiable in everything."""
    f_lat = _prior_at(model.kernel, paths.omega, paths.phase, paths.w, x)  # (S, L)
    return mix_latents(model, f_lat + _update_at(model, paths.v, x))


def _update_at(model: SVGP, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The canonical update k(x_s, Z_l) v_sl at per-sample inputs: (S, L)."""
    kern = model.kernel
    ls = kern.lengthscales  # (L, D)
    xs = x[:, None, :] / ls[None, :, :]  # (S, L, D)
    zs = model.z / ls[:, None, :]  # (L, M, D)
    x2 = torch.sum(xs * xs, dim=-1)
    z2 = torch.sum(zs * zs, dim=-1)
    xz = torch.einsum("sld,lmd->slm", xs, zs)
    d2 = torch.clamp(x2[..., None] + z2[None] - 2.0 * xz, min=0.0)
    kxz = kern.variance[None, :, None] * torch.exp(-0.5 * d2)
    return torch.einsum("slm,slm->sl", kxz, v)


def mix_latents(model: SVGP, f_lat: torch.Tensor) -> torch.Tensor:
    """Latent values (S, L) -> outputs (S, P): the mixing matrix, then the
    mean constant."""
    out = f_lat @ model.w.T if model.w is not None else f_lat
    return out + model.mean_const


class PathwiseSVGPTransform:
    """Drift callable carrying explicit path state.

    ``fused=True`` routes through the kernel op (ops/path_eval_cuda.py), with
    its operands prepared once here rather than on every call. Use it where
    the drift is frozen with respect to the loss (policy optimization): the
    op has no gradient for the drift's hyperparameters.
    """

    def __init__(self, model: SVGP, paths: PathState, fused: bool = False):
        self.model = model
        self.paths = paths
        self.fused = fused
        self._operands = fused_operands(model, paths) if fused else None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return eval_fused_operands(self.model, self._operands, x)
        return eval_paths_svgp(self.model, self.paths, x)


# ----------------------------------------------------------------------------
# exact GPR: plain torch, as in the JAX package (no kernel)
# ----------------------------------------------------------------------------
def generate_paths_gpr(
    model: GPR, generator: Optional[torch.Generator], num_samples: int, num_bases: int
) -> PathState:
    """Decoupled sampling for an exact GPR: one RFF frequency set per output
    column, and the canonical update solves (Knn + noise I) against
    y - f_prior(X) - a noise draw. A stacked GPR (K members) gives paths
    with a leading member axis (omega (K, P, B, D), w (K, S, P, B),
    v (K, S, P, N)), one N x N factorization per member, in one batch."""
    kern = model.kernel
    xdata = model.x
    n, d = xdata.shape
    p = model.y.shape[-1]
    batch = kern.variance.shape  # () or (K,)
    kw = dict(dtype=xdata.dtype, device=xdata.device, generator=generator)
    ls = kern.lengthscales  # (D,) or (K, D)
    omega = torch.randn(batch + (p, num_bases, d), **kw) / ls[..., None, None, :]
    phase = 2.0 * math.pi * torch.rand(batch + (p, num_bases), **kw)
    w = torch.randn(batch + (num_samples, p, num_bases), **kw)
    eps = torch.randn(batch + (num_samples, p, n), **kw)

    proj = torch.einsum("nd,...pbd->...pnb", xdata, omega) + phase[..., :, None, :]
    scale = torch.sqrt(2.0 * kern.variance / num_bases)[..., None, None, None]
    f_prior_x = torch.einsum("...pnb,...spb->...spn", scale * torch.cos(proj), w)
    noise = model.noise_variance[..., None, None, None]
    target = (model.y - model.mean_const[..., None, :]).mT  # (..., P, N)
    resid = target[..., None, :, :] - f_prior_x - torch.sqrt(noise) * eps  # (..., S, P, N)
    lyy = gpr_cholesky(model)
    # one solve per member, num_samples * P right-hand sides
    rhs = resid.reshape(batch + (num_samples * p, n)).mT
    v = bcho_solve(lyy, rhs).mT.reshape(batch + (num_samples, p, n))
    return PathState(omega=omega, phase=phase, w=w, v=v)


def eval_paths_gpr(model: GPR, paths: PathState, x: torch.Tensor) -> torch.Tensor:
    """Evaluate sample s at its own input: x (S, D) -> (S, P), or, for a
    stacked GPR, x (K, S, D) -> (K, S, P), member k's paths at its rows."""
    kern = model.kernel
    proj = torch.einsum("...sd,...pbd->...spb", x, paths.omega) + paths.phase[..., None, :, :]
    scale = torch.sqrt(2.0 * kern.variance / paths.omega.shape[-2])[..., None, None, None]
    f = torch.einsum("...spb,...spb->...sp", scale * torch.cos(proj), paths.w)
    ls = kern.lengthscales[..., None, None, :]
    d2 = torch.sum(((x[..., :, None, :] - model.x) / ls) ** 2, dim=-1)  # (..., S, N)
    kxz = kern.variance[..., None, None] * torch.exp(-0.5 * d2)
    f = f + torch.einsum("...sn,...spn->...sp", kxz, paths.v)
    return f + model.mean_const[..., None, :]


class PathwiseGPRTransform:
    """GPR drift callable carrying explicit path state. For a stacked GPR the
    particles (K * S, D) are taken member-major: rows k*S .. (k+1)*S - 1
    ride member k's paths."""

    def __init__(self, model: GPR, paths: PathState):
        self.model = model
        self.paths = paths

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.model.stacked:
            return eval_paths_gpr(self.model, self.paths, x)
        k = self.model.raw_noise.shape[0]
        f = eval_paths_gpr(self.model, self.paths, x.reshape(k, -1, x.shape[-1]))
        return f.reshape(x.shape[0], -1)


# ----------------------------------------------------------------------------
# the whole pathwise rollout loss as one kernel op (ops/rollout_cuda.py)
# ----------------------------------------------------------------------------
def _policy_alpha(policy_model: SVGP) -> torch.Tensor:
    """(Lp, Mp) weights of the policy's deterministic mean, Kuu^{-1} q_mu
    (Luu^{-T} q_mu when whitened), scaled by the kernel variance: the
    alpha of moment_matching/gp.py's svgp_match_cache without the factors
    a moment match needs and the rollout does not. Kuu's escalation is
    decided on the device, so a CUDA graph can hold it."""
    luu = chol_kuu(policy_model, on_device=True)
    q_mu = policy_model.q_mu.T[..., None]  # (Lp, Mp, 1)
    if policy_model.whiten:
        alpha = solve_triangular(luu, q_mu, lower=True, trans=1)[..., 0]
    else:
        alpha = bcho_solve(luu, q_mu)[..., 0]
    return policy_model.kernel.variance[:, None] * alpha


@tracing.span("rollout.operands")
def fused_rollout_operands(policy_model: SVGP, drift_model, paths: PathState, *, state_dim: int,
                           active_dims: Tuple[int, ...], action_scale: float, target, precis,
                           dt: float = 1.0, num_steps: int = 30):
    """(meta, operands after x0) of ``FusedRolloutLoss`` for an SVGP policy
    and an SVGP, GPR or stacked GPR drift with its paths (a stacked GPR's
    paths carry the member axis in front, its particles member-major).

    The policy's operands are built here in plain torch, inside the autograd
    graph, so the op's dzp, dalpha and dilp reach the policy's z, q_mu and
    lengthscales. A GPR's one shared kernel over its P outputs is stacked
    into P latents with the training inputs as the centers."""
    d = state_dim
    kern = drift_model.kernel
    num_bases = paths.omega.shape[-2]
    if isinstance(drift_model, GPR):
        ld, dxu = drift_model.y.shape[-1], drift_model.x.shape[-1]
        if ld != d:
            raise ValueError("a GPR drift needs as many outputs as state dims")
        k = kern.variance.shape[0] if drift_model.stacked else 1
        ild = (1.0 / kern.lengthscales).reshape(k, 1, dxu).expand(k, ld, dxu)
        zd = drift_model.x * ild[:, :, None, :]  # (K, P, N, Dxu)
        var = kern.variance.reshape(k, 1).expand(k, ld)
        omega = paths.omega.reshape(k, ld, num_bases, dxu)
        phase = paths.phase.reshape(k, ld, num_bases)
        mc_d = drift_model.mean_const.reshape(k, d)
        wd = None
    else:
        ld, k = drift_model.z.shape[0], 1
        ild = (1.0 / kern.lengthscales)[None]  # (1, Ld, Dxu)
        zd = drift_model.z[None] * ild[:, :, None, :]
        var = kern.variance[None]
        omega, phase = paths.omega[None], paths.phase[None]
        mc_d = drift_model.mean_const.expand(d)[None]
        wd = drift_model.w
    if wd is None:
        if ld != d:
            raise ValueError("a drift without a mixing matrix needs as many latents as state dims")
        wd = torch.eye(d, dtype=zd.dtype, device=zd.device)
    scale = torch.sqrt(2.0 * var / num_bases)  # (K, Ld)
    w = paths.w.reshape(k, -1, ld, num_bases) * scale[:, None, :, None]
    v = paths.v.reshape(k, -1, *paths.v.shape[-2:]) * var[:, None, :, None]

    pk = policy_model.kernel
    lp = policy_model.z.shape[0]
    ilp = 1.0 / pk.lengthscales  # (Lp, De)
    zp = policy_model.z * ilp[:, None, :]
    wp = policy_model.w
    if wp is None:
        wp = torch.eye(lp, dtype=zp.dtype, device=zp.device)
    u_dim = wp.shape[0]
    de = 2 * len(active_dims) + d - len(active_dims)
    if zd.shape[-1] != de + u_dim:
        raise ValueError("the drift's input dim is not the encoded state's plus the action's")
    meta = RolloutMeta(
        num_steps=num_steps, dt=float(dt), squash_scale=float(2.0 * action_scale - 1e-5),
        active_dims=tuple(int(a) for a in active_dims), state_dim=d, enc_dim=de, act_dim=u_dim,
        num_latent=ld, pol_latent=lp,
    )
    ops = (zp, torch.sum(zp * zp, -1), _policy_alpha(policy_model), ilp, wp,
           policy_model.mean_const.expand(u_dim), omega, phase, ild, zd, torch.sum(zd * zd, -1),
           w.reshape(-1, ld, num_bases), v.reshape(-1, *v.shape[-2:]), wd, mc_d, target, precis)
    return meta, tuple(t.contiguous() for t in ops)


def pathwise_rollout_loss_fused(policy_model: SVGP, drift_model, paths: PathState, x0, *,
                                active_dims, action_scale: float, target, precis,
                                dt: float = 1.0, num_steps: int = 30) -> torch.Tensor:
    """Per-particle whole-rollout pathwise loss (S,) through
    ``FusedRolloutLoss``. The drift, its paths and x0 are constants of the
    differentiated computation.

    On the card, with grad enabled, the operand packing and the op, forward
    and backward, are replayed from CUDA graphs (``ops/graphs.py``): x0 and
    the paths are copied in, the models' tensors, target and precis read in
    place."""
    kw = dict(state_dim=x0.shape[-1], active_dims=tuple(int(a) for a in active_dims),
              action_scale=float(action_scale), dt=float(dt), num_steps=int(num_steps))

    def costs(x0, omega, phase, w, v):
        meta, ops = fused_rollout_operands(policy_model, drift_model, PathState(omega, phase, w, v),
                                           target=target, precis=precis, **kw)
        return FusedRolloutLoss.apply(meta, x0.contiguous(), *ops)

    consts = (tuple(sorted(kw.items())), type(drift_model), policy_model.whiten,
              getattr(drift_model, "whiten", None), (policy_model.kernel.ls_low, policy_model.kernel.ls_high),
              (drift_model.kernel.ls_low, drift_model.kernel.ls_high))
    return graphs.graphed(costs, (x0, *paths), (policy_model, drift_model), (target, precis), consts)
