"""The whole pathwise policy-rollout loss as one CUDA kernel op, K6
(counterpart of gpflowpilco_tpu/ops/rollout_pallas.py).

For particles x0 (S, D), each riding its own sampled drift function, the op
runs all T rollout steps and returns the per-particle loss (S,):

    for t in 0..T-1:
        e    = encode(x)                          # sin/cos of the active dims
        g_l  = sum_m exp(-1/2 |e il_l - zp_lm|^2) alpha_lm     # policy latents
        u    = s (Phi(g Wp' + mc_p) - 1/2)        # squashed, LCK-mixed policy
        xu   = [e, u]
        f_l  = sum_b cos(xu . omega_lb + phase_lb) w_slb
               + sum_m exp(-1/2 |xu ild_l - zd_lm|^2) v_slm    # drift latents
        x    = x + dt (f Wd' + mc_d)
        loss += -exp(-1/2 (encode(x) - target)' P (encode(x) - target))

On the card the forward runs each particle's T steps in its own warps, with
the member's drift tables in shared memory (``fwd_plan`` gives the route
and its shared memory) and a scratch of ``fwd_panel_elems`` elements for
them allocated here. ``FusedRolloutLoss`` saves only the (T+1, S,
D) trajectory; its backward recomputes every step's internals and returns
gradients for the policy operands (zp, alpha, ilp) alone, as the JAX
``custom_vjp`` does. On the card the backward is one entry of four
launches: every step's drift Jacobians and linear maps at once, the adjoint
recurrence per particle, then the policy gradients, with a scratch of
``bwd_scratch_sizes`` elements (a few MB at S=1024, T=30) allocated here.
zp2 = sum(zp^2) gets no cotangent: the dzp formula is already the total
derivative through it. Every other operand is frozen (policy optimization)
and asking for its gradient raises.

The drift operands carry a leading member axis K (1 for an SVGP drift): an
HMC ensemble's K members ride one launch, particle s reading member
s // (S / K), where the JAX package vmaps one kernel call per member.

Dispatch is by the device of the tensors: CUDA tensors go to the kernels of
``csrc/rollout.cu`` (float32 or float64, contiguous, within the register
capacities below, else the wrapper raises), CPU tensors to
``rollout_reference`` and ``rollout_reference_bwd``. There is no fallback
from one to the other. ``launches`` counts entry calls that launch kernels
(one per call, whatever the number of launches in it).

The normal CDF is exact here (``torch.special.ndtr``; ``normcdf`` in the
kernel), where the TPU kernel used the Abramowitz-Stegun approximation for
want of ``erf``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from ..utils import tracing
from . import _build

# kernel launches per entry; reset with reset_launches()
launches = tracing.register_launches(
    {f"rollout_{kind}_{sfx}": 0 for kind in ("fwd", "bwd") for sfx in ("f32", "f64")})

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# csrc/rollout.cu's register capacities: state dim, drift input (De + U),
# action, policy latents, drift latents; active dims travel as 4-bit fields
MAX_D, MAX_DXU, MAX_U, MAX_LP, MAX_LD = 8, 16, 4, 4, 8
GRAD_ROWS = 64  # (step, particle) rows per slot of the backward's dzp and dalpha (kGradRows)
FWD_SMEM_MAX = 232448  # dynamic shared memory a forward block may use on an H100 (kSmemMax)
FWD_XCH_BYTES = 3072  # the forward's exchange area between a particle's warps (kXchBytes)
FWD_STREAM_SLOTS = 4  # 16-byte weight slots a forward thread keeps in flight (kStream)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

OPERANDS = ("x0", "zp", "zp2", "alpha", "ilp", "wp", "mc_p", "omega", "phase", "ild", "zd",
            "zd2", "w", "v", "wd", "mc_d", "target", "precis")
# positions in FusedRolloutLoss.apply's arguments (meta first) that may carry
# a gradient: zp, zp2 (computed from zp; its cotangent is zero), alpha, ilp
_TRAINABLE = (2, 3, 4, 5)


class RolloutMeta(NamedTuple):
    """Static configuration of the rollout."""

    num_steps: int
    dt: float
    squash_scale: float  # 2 * action_scale - 1e-5
    active_dims: Tuple[int, ...]  # encoder active dims, in the encoder's order
    state_dim: int  # D
    enc_dim: int  # De = 2a + (D - a)
    act_dim: int  # U
    num_latent: int  # Ld drift latents (== D where Wd is the identity)
    pol_latent: int  # Lp policy latents (== U where Wp is the identity)


def reset_launches():
    for k in launches:
        launches[k] = 0


def operand_check(name: str, meta: RolloutMeta, ops, extra=()):
    """(S, K, B, M, Mp): raise ValueError unless every operand has the shape
    the kernels index it by and the meta fits the register capacities, and
    TypeError unless all share one float32 or float64 dtype."""
    t = dict(zip(OPERANDS, ops))
    s, d = t["x0"].shape
    k, ld, b, dxu = t["omega"].shape
    m = t["zd"].shape[2]
    lp, mp, de = t["zp"].shape
    u = t["wp"].shape[0]
    shapes = dict(
        x0=(s, d), zp=(lp, mp, de), zp2=(lp, mp), alpha=(lp, mp), ilp=(lp, de), wp=(u, lp),
        mc_p=(u,), omega=(k, ld, b, dxu), phase=(k, ld, b), ild=(k, ld, dxu), zd=(k, ld, m, dxu),
        zd2=(k, ld, m), w=(s, ld, b), v=(s, ld, m), wd=(d, ld), mc_d=(k, d), target=(de,),
        precis=(de, de),
    )
    want = [(f, t[f], shapes[f]) for f in OPERANDS] + list(extra)
    for what, x, shape in want:
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    fields = (d, meta.enc_dim, meta.act_dim, meta.pol_latent, meta.num_latent)
    if fields != (meta.state_dim, de, u, lp, ld) or dxu != de + u or s % k:
        raise ValueError(f"{name}: operands (D, De, U, Lp, Ld, Dxu, S, K) = "
                         f"{(d, de, u, lp, ld, dxu, s, k)} do not fit {meta}")
    if d > MAX_D or dxu > MAX_DXU or u > MAX_U or lp > MAX_LP or ld > MAX_LD:
        raise ValueError(
            f"{name}: the kernels take D <= {MAX_D}, De + U <= {MAX_DXU}, U <= {MAX_U}, "
            f"Lp <= {MAX_LP} and Ld <= {MAX_LD}, got {d}, {dxu}, {u}, {lp}, {ld}"
        )
    dtypes = {x.dtype for _, x, _ in want}
    if len(dtypes) != 1 or t["x0"].dtype not in _SUFFIX:
        raise TypeError(f"{name}: operands must share float32 or float64, got {dtypes}")
    return s, k, b, m, mp


# ----------------------------------------------------------------- plain torch
@functools.lru_cache(maxsize=None)
def _index(meta: RolloutMeta, device):
    """Active and inactive index tensors, made once per meta and device."""
    a = tuple(meta.active_dims)
    b = tuple(i for i in range(meta.state_dim) if i not in set(a))
    return (torch.tensor(a, dtype=torch.long, device=device),
            torch.tensor(b, dtype=torch.long, device=device))


def _encode(meta: RolloutMeta, x):
    """e = [sin x_a, cos x_a, x_inactive] (components.Encoder with SinCos)."""
    a, b = _index(meta, x.device)
    xa = torch.index_select(x, -1, a)
    parts = [torch.sin(xa), torch.cos(xa)]
    if b.numel():
        parts.append(torch.index_select(x, -1, b))
    return torch.cat(parts, dim=-1)


def _encode_bwd(meta: RolloutMeta, x, ge):
    """dx from de: active dim j gets cos(x_j) ge_sin_j - sin(x_j) ge_cos_j,
    the inactive dims pass through."""
    a, b = _index(meta, x.device)
    na = a.numel()
    xa = torch.index_select(x, -1, a)
    gx = torch.zeros_like(x)
    gx = gx.index_add(-1, a, ge[..., :na] * torch.cos(xa) - ge[..., na:2 * na] * torch.sin(xa))
    if b.numel():
        gx = gx.index_add(-1, b, ge[..., 2 * na:])
    return gx


def _policy(e, zp, zp2, alpha, ilp, wp, mc_p):
    """Scaled inputs es (K, P, Lp, De), grams kp (K, P, Lp, Mp) and the
    pre-squash action graw (K, P, U) at encoded states e (K, P, De)."""
    es = e[..., None, :] * ilp
    ez = torch.einsum("kpld,lmd->kplm", es, zp)
    d2 = torch.clamp(torch.sum(es * es, -1)[..., None] + zp2 - 2.0 * ez, min=0.0)
    kp = torch.exp(-0.5 * d2)
    return es, kp, torch.einsum("kplm,lm->kpl", kp, alpha) @ wp.T + mc_p


def _drift_terms(xu, omega, phase, ild, zd, zd2):
    """proj (K, P, Ld, B), scaled inputs xs (K, P, Ld, Dxu) and the
    unit-variance canonical gram (K, P, Ld, M) at xu (K, P, Dxu)."""
    proj = torch.einsum("kpd,klbd->kplb", xu, omega) + phase[:, None]
    xs = xu[:, :, None, :] * ild[:, None]
    xz = torch.einsum("kpld,klmd->kplm", xs, zd)
    d2 = torch.clamp(torch.sum(xs * xs, -1)[..., None] + zd2[:, None] - 2.0 * xz, min=0.0)
    return proj, xs, torch.exp(-0.5 * d2)


def _cost(x_enc, target, precis):
    err = x_enc - target
    return -torch.exp(-0.5 * torch.sum(err * (err @ precis.T), -1)), err


def _by_member(k, *tensors):
    """Particle-major (S, ...) tensors as (K, S / K, ...)."""
    return [t.reshape(k, t.shape[0] // k, *t.shape[1:]) for t in tensors]


def _rollout(meta: RolloutMeta, x0, zp, zp2, alpha, ilp, wp, mc_p, omega, phase, ild, zd, zd2,
             w, v, wd, mc_d, target, precis):
    """(loss (S,), trajectory (T+1, S, D)), plain torch, differentiable."""
    k, s = omega.shape[0], x0.shape[0]
    x, w4, v4 = _by_member(k, x0, w, v)
    loss = torch.zeros(x.shape[:2], dtype=x0.dtype, device=x0.device)
    traj = [x]
    for _ in range(meta.num_steps):
        e = _encode(meta, x)
        _, _, graw = _policy(e, zp, zp2, alpha, ilp, wp, mc_p)
        xu = torch.cat([e, meta.squash_scale * (torch.special.ndtr(graw) - 0.5)], dim=-1)
        proj, _, kd = _drift_terms(xu, omega, phase, ild, zd, zd2)
        f_lat = torch.sum(torch.cos(proj) * w4, -1) + torch.sum(kd * v4, -1)  # (K, P, Ld)
        x = x + meta.dt * (f_lat @ wd.T + mc_d[:, None])
        loss = loss + _cost(_encode(meta, x), target, precis)[0]
        traj.append(x)
    return loss.reshape(s), torch.stack(traj).reshape(meta.num_steps + 1, s, -1)


def rollout_reference(meta: RolloutMeta, *ops):
    """Plain torch per-particle loss (S,) from the operands in ``OPERANDS``
    order; differentiable by autograd in every operand."""
    return _rollout(meta, *ops)[0]


def rollout_reference_bwd(meta: RolloutMeta, traj, gl, zp, zp2, alpha, ilp, wp, mc_p, omega,
                          phase, ild, zd, zd2, w, v, wd, mc_d, target, precis):
    """Plain torch restatement of the kernel's reverse-time adjoint: from the
    trajectory (T+1, S, D) and the loss cotangent gl (S,), (dzp, dalpha,
    dilp) summed over the particles."""
    k = omega.shape[0]
    traj = traj.reshape(traj.shape[0], k, -1, traj.shape[-1])
    w4, v4 = _by_member(k, w, v)
    glk = gl.reshape(k, -1, 1)
    psym = 0.5 * (precis + precis.T)
    de = meta.enc_dim
    g = torch.zeros_like(traj[0])
    dzp, dal, dilp = torch.zeros_like(zp), torch.zeros_like(alpha), torch.zeros_like(ilp)
    for t in reversed(range(meta.num_steps)):
        x, x1 = traj[t], traj[t + 1]
        # the cost at x_{t+1}: dc/derr = -c sym(P) err
        c, err = _cost(_encode(meta, x1), target, precis)
        g1 = g + _encode_bwd(meta, x1, (glk * -c[..., None]) * (err @ psym))
        # the step's internals at x_t, recomputed
        e = _encode(meta, x)
        es, kp, graw = _policy(e, zp, zp2, alpha, ilp, wp, mc_p)
        xu = torch.cat([e, meta.squash_scale * (torch.special.ndtr(graw) - 0.5)], dim=-1)
        proj, xs, kd = _drift_terms(xu, omega, phase, ild, zd, zd2)
        gf = meta.dt * (g1 @ wd)  # (K, P, Ld): through the Wd mixing
        dxu_prior = -torch.einsum("kplb,klbd->kpld", torch.sin(proj) * w4, omega)
        kv = kd * v4
        dxu_canon = (torch.einsum("kplm,klmd->kpld", kv, zd)
                     - torch.sum(kv, -1, keepdim=True) * xs) * ild[:, None]
        gxu = torch.sum(gf[..., None] * (dxu_prior + dxu_canon), dim=2)  # (K, P, Dxu)
        # the squash: du/dgraw = s pdf(graw), then the Wp mixing
        pdf = _INV_SQRT_2PI * torch.exp(-0.5 * graw * graw)
        glat_g = (gxu[..., de:] * (meta.squash_scale * pdf)) @ wp  # (K, P, Lp)
        # the policy latents
        amat = kp * glat_g[..., None] * alpha  # (K, P, Lp, Mp)
        dal = dal + torch.einsum("kplm,kpl->lm", kp, glat_g)
        ges = torch.einsum("kplm,lmd->kpld", amat, zp) - es * torch.sum(amat, -1)[..., None]
        dzp = dzp + torch.einsum("kplm,kpld->lmd", amat, es) - torch.sum(amat, (0, 1))[..., None] * zp
        dilp = dilp + torch.einsum("kpld,kpd->ld", ges, e)
        g = g1 + _encode_bwd(meta, x, gxu[..., :de] + torch.sum(ges * ilp, dim=2))
    return dzp, dal, dilp


# ----------------------------------------------------------------- dispatch
def _ints(meta: RolloutMeta, s, k, b, m, mp):
    code = 0
    for j, a in enumerate(meta.active_dims):
        code |= a << (4 * j)
    vals = (s, k, s // k, meta.num_steps, meta.state_dim, meta.enc_dim, meta.act_dim,
            meta.pol_latent, mp, meta.num_latent, b, m, code, len(meta.active_dims))
    return (*(ctypes.c_int(v) for v in vals), ctypes.c_double(meta.dt),
            ctypes.c_double(meta.squash_scale))


def _fwd_width(meta: RolloutMeta) -> int:
    """The forward's table rows a latent (DXU >= De + U: 6, 8 or 16)."""
    dxu = meta.enc_dim + meta.act_dim
    return 6 if dxu <= 6 else 8 if dxu <= 8 else 16


def _fwd_table_elems(meta: RolloutMeta, b: int, m: int, dtype) -> int:
    """One member's drift tables in the forward's panel layout: per drift
    latent DXU + 1 rows of the bases' and the centers' columns, each padded
    to a 16-byte group (csrc/rollout.cu's fwd_panels)."""
    group = 16 // (torch.finfo(dtype).bits // 8)
    pad = lambda n: -(-n // group) * group  # noqa: E731
    return meta.num_latent * (_fwd_width(meta) + 1) * (pad(b) + pad(m))


def fwd_panel_elems(meta: RolloutMeta, k: int, b: int, m: int, dtype) -> int:
    """Elements of the forward's panel scratch: the K members' tables, then
    per member and latent the largest magnitude of each bases row."""
    return k * (_fwd_table_elems(meta, b, m, dtype) + meta.num_latent * (_fwd_width(meta) + 1))


def fwd_plan(meta: RolloutMeta, b: int, m: int, dtype) -> Tuple[str, int]:
    """(route, dynamic shared memory in bytes) of the forward kernel: the
    member's drift tables resident in shared memory for all T steps where
    they fit in FWD_SMEM_MAX ("resident"), else streamed every step through
    two chunk buffers ("ring"). Mirrors csrc/rollout.cu's fwd_smem_bytes:
    one member's panels (_fwd_table_elems), or two chunks of 1024 columns
    (512 in float64 at DXU = 16); both add the exchange area between a
    particle's warps and the threads' weight streams (FWD_STREAM_SLOTS
    16-byte slots each; 8 particles a block, two warps each at DXU <= 8, one
    at 16). A block holds one member's tables, whatever the member count."""
    size = torch.finfo(dtype).bits // 8
    width = _fwd_width(meta)
    front = FWD_XCH_BYTES + FWD_STREAM_SLOTS * 32 * 8 * (2 if width <= 8 else 1) * 16
    resident = front + _fwd_table_elems(meta, b, m, dtype) * size
    if resident <= FWD_SMEM_MAX:
        return "resident", resident
    cols = 512 if size == 8 and width > 8 else 1024
    return "ring", front + 2 * (width + 1) * cols * size


def _fwd(meta: RolloutMeta, *ops, route=None):
    """(loss (S,), trajectory (T+1, S, D)). ``route`` ("resident" or "ring")
    overrides fwd_plan's choice on the card (a resident route that does not
    fit raises); both give bit-identical results. On the card the check,
    the plan and the launch are the span ``k6.fwd``."""
    if ops[0].device.type == "cpu":
        _fwd_check(meta, ops, route)
        return _rollout(meta, *ops)
    with tracing.span("k6.fwd"):
        return _fwd_card(meta, ops, route)


def _fwd_check(meta: RolloutMeta, ops, route):
    shape = operand_check("rollout_fwd", meta, ops)
    if route not in (None, "resident", "ring"):
        raise ValueError(f"rollout_fwd: route must be 'resident' or 'ring', got {route!r}")
    return shape


def _fwd_card(meta: RolloutMeta, ops, route):
    shape = _fwd_check(meta, ops, route)
    x0 = ops[0]
    s, k, b, m, _ = shape
    route = route or fwd_plan(meta, b, m, x0.dtype)[0]
    new = lambda *sh: torch.empty(sh, dtype=x0.dtype, device=x0.device)  # noqa: E731
    panels = new(fwd_panel_elems(meta, k, b, m, x0.dtype))
    loss, traj = new(s), new(meta.num_steps + 1, s, meta.state_dim)
    name = f"rollout_fwd_{_SUFFIX[x0.dtype]}"
    _build.launch("rollout", name, (*ops, panels, loss, traj), *_ints(meta, *shape),
                  ctypes.c_int(route == "ring"))
    launches[name] += 1
    return loss, traj


def bwd_scratch_sizes(meta: RolloutMeta, s: int):
    """Elements of the backward's scratch, (jac, maps, glat): per (step,
    particle) row the drift Jacobians (Ld x Dxu), the step's linear maps
    (A_t^T D x D, the policy-latent map Lp x D, the cost term D, h e Lp x
    De) and the policy-latents' cotangent (Lp)."""
    rows = meta.num_steps * s
    d, lp = meta.state_dim, meta.pol_latent
    nm = d * d + lp * d + d + lp * meta.enc_dim
    return rows * meta.num_latent * (meta.enc_dim + meta.act_dim), rows * nm, rows * lp


def _bwd(meta: RolloutMeta, traj, gl, *ops):
    """(dzp, dalpha, dilp) from the trajectory and the loss cotangent; ``ops``
    are the operands after x0. On the card the check, the scratch and the
    launch are the span ``k6.bwd``."""
    if traj.device.type == "cpu":
        _bwd_check(meta, traj, gl, ops)
        return rollout_reference_bwd(meta, traj, gl, *ops)
    with tracing.span("k6.bwd"):
        return _bwd_card(meta, traj, gl, ops)


def _bwd_check(meta: RolloutMeta, traj, gl, ops):
    x0 = traj[0]
    s = x0.shape[0]
    extra = (("trajectory", traj, (meta.num_steps + 1, s, meta.state_dim)), ("gl", gl, (s,)))
    return operand_check("rollout_bwd", meta, (x0, *ops), extra)


def _bwd_card(meta: RolloutMeta, traj, gl, ops):
    shape = _bwd_check(meta, traj, gl, ops)
    x0 = traj[0]
    s = x0.shape[0]
    sizes = bwd_scratch_sizes(meta, s)
    if max(sizes) >= 2**31:
        raise ValueError(f"rollout_bwd: T x S = {meta.num_steps} x {s} rows need scratch of {sizes} "
                         f"elements; the kernels index rows by int and take fewer than 2**31")
    zp, alpha, ilp = ops[0], ops[2], ops[3]
    scratch = torch.empty((sum(sizes),), dtype=x0.dtype, device=x0.device)
    jac, maps, glat = scratch.split(sizes)
    nslot = -(-(meta.num_steps * s) // GRAD_ROWS)
    new = lambda n, like: torch.empty((n, *like.shape), dtype=like.dtype, device=like.device)  # noqa: E731
    dzp, dal, dilp = new(nslot, zp), new(nslot, alpha), new(s, ilp)
    name = f"rollout_bwd_{_SUFFIX[x0.dtype]}"
    _build.launch("rollout", name, (traj, gl, *ops, jac, maps, glat, dzp, dal, dilp), *_ints(meta, *shape))
    launches[name] += 1
    # per-slot and per-particle partial sums, added in order outside the kernels: no atomics
    return dzp.sum(0), dal.sum(0), dilp.sum(0)


class FusedRolloutLoss(torch.autograd.Function):
    """Per-particle loss (S,) from the operands in ``OPERANDS`` order:
    x0 (S, D); zp (Lp, Mp, De) pre-scaled by ilp; zp2 (Lp, Mp); alpha
    (Lp, Mp) pre-scaled by the kernel variance; ilp (Lp, De); wp (U, Lp);
    mc_p (U,); omega (K, Ld, B, Dxu); phase (K, Ld, B); ild (K, Ld, Dxu);
    zd (K, Ld, M, Dxu) pre-scaled; zd2 (K, Ld, M); w (S, Ld, B) pre-scaled
    by sqrt(2 var / B); v (S, Ld, M) pre-scaled by var; wd (D, Ld); mc_d
    (K, D); target (De,); precis (De, De). Differentiable in zp, alpha and
    ilp only."""

    @staticmethod
    def forward(ctx, meta, *ops):
        frozen = [OPERANDS[i - 1] for i, need in enumerate(ctx.needs_input_grad)
                  if need and i not in _TRAINABLE]
        if frozen:
            raise NotImplementedError(
                f"FusedRolloutLoss differentiates only the policy operands (zp, alpha, ilp); "
                f"{frozen} would silently get no gradient. Use the unfused rollout "
                f"(loops/pilco.py PathwisePILCO) for that computation."
            )
        loss, traj = _fwd(meta, *ops)
        ctx.meta = meta
        ctx.save_for_backward(traj, *ops[1:])
        return loss

    @staticmethod
    def backward(ctx, gl):
        traj, *ops = ctx.saved_tensors
        dzp, dal, dilp = _bwd(ctx.meta, traj, gl.contiguous(), *ops)
        need = ctx.needs_input_grad
        return (None, None, dzp if need[2] else None, None, dal if need[4] else None,
                dilp if need[5] else None, *(None,) * (len(OPERANDS) - 5))
