"""Fused pathwise GP drift evaluation: the CUDA kernel op
(counterpart of gpflowpilco_tpu/ops/path_eval_pallas.py).

For every particle s and latent l,

    f[s, l] = sum_b cos(x_s . omega_lb + phase_lb) * w_slb      (RFF prior)
            + sum_m exp(-1/2 |x~_s - z~_lm|^2) * v_slm          (canonical)

with w and v pre-scaled by the per-latent scalars outside the autograd
boundary, as in the JAX ``custom_vjp``. ``FusedPathEval`` takes
(x, w_scaled, v_scaled, omega, phase, z_scaled, z2, inv_ls) and saves its
inputs; the backward recomputes the projections. Its backward picks, from
``ctx.needs_input_grad``, the dx-only kernel (paths frozen: policy
optimization) or the full one (w or v perturbed). Gradients for omega, phase
or the kernel hyperparameters raise, as the JAX VJP does.

Dispatch is by the device of the tensors: CUDA tensors go to the kernels of
``csrc/path_eval.cu`` (float32 or float64, all operands of one type,
contiguous, else the wrapper raises), CPU tensors to
``path_eval_reference`` and its backward formulas. There is no fallback
from one to the other. ``launches`` counts kernel launches only, by entry
and type: the float32 entries' keys are the entry's name, the float64
entries' end in ``_f64``. Every entry stages each latent's tables in
shared memory in chunks of columns that ``fwd_plan`` sizes for the type
(one chunk at the pathwise path's widths in both types); both backwards
write per-latent partials (L, S, D) of dx into a scratch the wrapper
allocates, and a second launch adds them in latent order.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from . import _build

# calls that launched each entry's kernels (a backward's one call is two
# launches at L > 1); reset with reset_launches()
ENTRIES = ("path_eval_fwd", "path_eval_bwd_dx", "path_eval_bwd_full")
_KEY = {torch.float32: "", torch.float64: "_f64"}  # the launch counts' keys
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}  # the kernels' exported names
launches = tracing.register_launches(
    {name + key: 0 for key in _KEY.values() for name in ENTRIES})

_MAX_D = 16  # kMaxD in csrc/path_eval.cu: x rows are held in registers
# every entry's shared memory (csrc/path_eval.cu): a block's weight ring
# (kRing = 4 groups of 4 values for each of its threads: 1024 in float32,
# 512 in float64, 64 KB in both), then the panels; at most FWD_SMEM_MAX
# bytes a block
FWD_RING_BYTES = 4 * 4 * 4 * 1024
FWD_SMEM_MAX = 232448


def reset_launches():
    for k in launches:
        launches[k] = 0


def _launch(name: str, inputs, outputs, *extra):
    """Check the operands and launch ``name``'s kernel of their type on the
    current stream, with the shape's ints and then ``extra``'s."""
    shape = operand_shape(*inputs)
    dtypes = {t.dtype for t in (*inputs, *outputs)}
    if len(dtypes) != 1 or inputs[0].dtype not in _SUFFIX:
        raise TypeError(f"{name}: the CUDA kernels take operands of one type, float32 or float64, got {dtypes}")
    dtype = inputs[0].dtype
    _build.launch("path_eval", f"{name}_{_SUFFIX[dtype]}", (*inputs, *outputs),
                  *(ctypes.c_int(v) for v in (*shape, *extra)))
    launches[name + _KEY[dtype]] += 1


def fwd_plan(b: int, m: int, d: int, elem: int = 4):
    """(cw, bytes) of every entry for values of ``elem`` bytes (4: float32,
    8: float64): the width of the chunks of columns in which a block stages
    its latent's panels (D + 1 rows over the bases, then the centers, each
    rounded up to 4 columns), a multiple of 128 (so each lane has as many
    groups of 4 in every chunk), as wide as all the columns where they fit
    beside the ring; and the dynamic shared memory that takes."""
    cols = -(-b // 4) * 4 + -(-m // 4) * 4
    fit = (FWD_SMEM_MAX - FWD_RING_BYTES) // (elem * (d + 1)) // 128 * 128
    cw = min(-(-cols // 128) * 128, fit)
    return cw, FWD_RING_BYTES + elem * (d + 1) * cw


def _chunk(x, w, v):
    """fwd_plan's chunk width for these operands."""
    return fwd_plan(w.shape[2], v.shape[2], x.shape[1], x.element_size())[0]


def operand_shape(x, w, v, omega, phase, z_scaled, z2, inv_ls, g=None):
    """(S, L, B, M, D) of the operands; raises ValueError unless every operand
    has the shape the kernels index it by (and D <= 16)."""
    s, d = x.shape
    _, num_latent, b = w.shape
    m = v.shape[-1]
    want = {
        "w": (w, (s, num_latent, b)), "v": (v, (s, num_latent, m)),
        "omega": (omega, (num_latent, b, d)), "phase": (phase, (num_latent, b)),
        "z_scaled": (z_scaled, (num_latent, m, d)), "z2": (z2, (num_latent, m)),
        "inv_ls": (inv_ls, (num_latent, d)),
    }
    if g is not None:
        want["g"] = (g, (s, num_latent))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"path eval: {name} has shape {tuple(t.shape)}, expected {shape}")
    if d > _MAX_D:
        raise ValueError(f"path eval: the kernels take D <= {_MAX_D} inputs, got {d}")
    return s, num_latent, b, m, d


# ----------------------------------------------------------------- plain torch
def _proj_and_k(x, omega, phase, z_scaled, z2, inv_ls):
    """proj (S, L, B), xs (S, L, D) and the unit-variance gram k (S, L, M)."""
    proj = torch.einsum("sd,lbd->slb", x, omega) + phase
    xs = x[:, None, :] * inv_ls  # (S, L, D)
    x2 = torch.sum(xs * xs, dim=-1)  # (S, L)
    xz = torch.einsum("sld,lmd->slm", xs, z_scaled)
    d2 = torch.clamp(x2[..., None] + z2 - 2.0 * xz, min=0.0)
    return proj, xs, torch.exp(-0.5 * d2)


def path_eval_reference(x, w, v, omega, phase, z_scaled, z2, inv_ls):
    """Plain-torch f (S, L): the same inputs and outputs as the kernel."""
    proj, _, k = _proj_and_k(x, omega, phase, z_scaled, z2, inv_ls)
    return torch.sum(torch.cos(proj) * w, dim=-1) + torch.sum(k * v, dim=-1)


def path_eval_reference_bwd(x, w, v, omega, phase, z_scaled, z2, inv_ls, g, want_wv):
    """Plain-torch backward: dx, and dw, dv when ``want_wv`` (else None)."""
    proj, xs, k = _proj_and_k(x, omega, phase, z_scaled, z2, inv_ls)
    g3 = g[..., None]  # (S, L, 1)
    dx_prior = -torch.einsum("slb,lbd->sld", torch.sin(proj) * w * g3, omega)
    kv = k * v * g3  # (S, L, M)
    dx_canon = (
        torch.einsum("slm,lmd->sld", kv, z_scaled) - torch.sum(kv, -1, keepdim=True) * xs
    ) * inv_ls
    dx = torch.sum(dx_prior + dx_canon, dim=1)
    if not want_wv:
        return dx, None, None
    return dx, torch.cos(proj) * g3, k * g3


# ----------------------------------------------------------------- dispatch
def _fwd(x, w, v, omega, phase, z_scaled, z2, inv_ls):
    if x.device.type == "cpu":
        return path_eval_reference(x, w, v, omega, phase, z_scaled, z2, inv_ls)
    out = torch.empty(w.shape[:2], dtype=x.dtype, device=x.device)
    _launch("path_eval_fwd", (x, w, v, omega, phase, z_scaled, z2, inv_ls), (out,), _chunk(x, w, v))
    return out


def _partials(x, w):
    """The backwards' (L, S, D) scratch of per-latent partials, which a
    second launch adds in order (the kernel writes dx itself at L = 1)."""
    return torch.empty((w.shape[1], *x.shape), dtype=x.dtype, device=x.device)


def _bwd_dx(x, w, v, omega, phase, z_scaled, z2, inv_ls, g):
    if x.device.type == "cpu":
        return path_eval_reference_bwd(
            x, w, v, omega, phase, z_scaled, z2, inv_ls, g, want_wv=False
        )[0]
    dx = torch.empty_like(x)
    _launch("path_eval_bwd_dx", (x, w, v, omega, phase, z_scaled, z2, inv_ls, g), (dx, _partials(x, w)),
            _chunk(x, w, v))
    return dx


def _bwd_full(x, w, v, omega, phase, z_scaled, z2, inv_ls, g):
    if x.device.type == "cpu":
        return path_eval_reference_bwd(
            x, w, v, omega, phase, z_scaled, z2, inv_ls, g, want_wv=True
        )
    dx, dw, dv = torch.empty_like(x), torch.empty_like(w), torch.empty_like(v)
    _launch("path_eval_bwd_full", (x, w, v, omega, phase, z_scaled, z2, inv_ls, g),
            (dx, dw, dv, _partials(x, w)), _chunk(x, w, v))
    return dx, dw, dv


class FusedPathEval(torch.autograd.Function):
    """f (S, L) from x (S, D), w (S, L, B) [pre-scaled by sqrt(2 var / B)],
    v (S, L, M) [pre-scaled by var], omega (L, B, D), phase (L, B),
    z_scaled (L, M, D), z2 (L, M), inv_ls (L, D)."""

    @staticmethod
    def forward(ctx, x, w, v, omega, phase, z_scaled, z2, inv_ls):
        if any(ctx.needs_input_grad[3:]):
            raise NotImplementedError(
                "FusedPathEval has no gradient for the RFF frequencies/phases or "
                "the kernel hyperparameters; use models.pathwise.eval_paths_svgp "
                "to differentiate through them"
            )
        ctx.save_for_backward(x, w, v, omega, phase, z_scaled, z2, inv_ls)
        return _fwd(x, w, v, omega, phase, z_scaled, z2, inv_ls)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        g = g.contiguous()
        dw = dv = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dx, dw, dv = _bwd_full(*saved, g)
        else:
            # paths frozen: no dw/dv to compute or write
            dx = _bwd_dx(*saved, g)
        return (
            dx if ctx.needs_input_grad[0] else None,
            dw if ctx.needs_input_grad[1] else None,
            dv if ctx.needs_input_grad[2] else None,
            None, None, None, None, None,
        )


def fused_operands(model, paths):
    """(w_scaled, v_scaled, omega, phase, z_scaled, z2, inv_ls): the per-latent
    scalars folded outside the autograd boundary, contiguous, once per path
    draw."""
    kern = model.kernel
    inv_ls = 1.0 / kern.lengthscales  # (L, D)
    z_scaled = model.z * inv_ls[:, None, :]
    z2 = torch.sum(z_scaled * z_scaled, dim=-1)
    scale = torch.sqrt(2.0 * kern.variance / paths.omega.shape[-2])
    w_scaled = paths.w * scale[None, :, None]
    v_scaled = paths.v * kern.variance[None, :, None]
    return tuple(
        t.contiguous()
        for t in (w_scaled, v_scaled, paths.omega, paths.phase, z_scaled, z2, inv_ls)
    )


def eval_fused_operands(model, operands, x):
    """Drift (S, P) at x (S, D) from ``fused_operands``."""
    f_lat = FusedPathEval.apply(x.contiguous(), *operands)
    out = f_lat @ model.w.T if model.w is not None else f_lat
    return out + model.mean_const


def eval_paths_svgp_fused(model, paths, x):
    """Drop-in for models.pathwise.eval_paths_svgp through the kernel op.
    Valid where the drift and its paths are constants of the differentiated
    computation, or where only w and v are perturbed."""
    return eval_fused_operands(model, fused_operands(model, paths), x)

