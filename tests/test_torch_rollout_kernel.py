"""The whole-rollout pathwise loss op (gpflowpilco_torch/ops/rollout_cuda.py,
K6) on the CPU, where it runs its plain versions: the plain forward against
the JAX package's unfused composition and its kernel restatement, the hand
adjoint against autograd, the CUDA backward's three phases restated in torch
against the hand adjoint, the frozen guard, ragged particle counts, and the
loop's ``use_fused_rollout`` path against the per-step one. Float64, the
shapes of tests/test_rollout_pallas.py (S=64, B=32, M=24, Mp=12, T=7)."""
import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.components import Encoder as JaxEncoder
from gpflowpilco_tpu.components import GaussianObjective as JaxGaussianObjective
from gpflowpilco_tpu.dynamics.forward import forward_concrete as jax_forward_concrete
from gpflowpilco_tpu.dynamics.solvers import euler_rollout as jax_euler_rollout
from gpflowpilco_tpu.models.gp import GPR as JaxGPR
from gpflowpilco_tpu.models.pathwise import PathwiseGPRTransform as JaxPathwiseGPRTransform
from gpflowpilco_tpu.models.pathwise import PathwiseSVGPTransform as JaxPathwiseSVGPTransform
from gpflowpilco_tpu.models.pathwise import generate_paths_gpr as jax_generate_paths_gpr
from gpflowpilco_tpu.models.pathwise import generate_paths_svgp as jax_generate_paths_svgp
from gpflowpilco_tpu.moment_matching.gp import SVGPTransform as JaxSVGPTransform
from gpflowpilco_tpu.moment_matching.rules import SinCos as JaxSinCos
from gpflowpilco_tpu.moment_matching.rules import SquashedProbit as JaxSquashedProbit
from gpflowpilco_tpu.moments import Chain as JaxChain
from gpflowpilco_tpu.ops import rollout_pallas as jax_rollout
from gpflowpilco_torch.components import Encoder
from gpflowpilco_torch.convert import gpr_ensemble_from_numpy, gpr_from_numpy, paths_from_numpy, svgp_from_numpy
from gpflowpilco_torch.loops.pilco import DriftSpec, PolicySpec
from gpflowpilco_torch.models.builders import policy_mask
from gpflowpilco_torch.models.pathwise import fused_rollout_operands, pathwise_rollout_loss_fused
from gpflowpilco_torch.moment_matching.rules import Identity
from gpflowpilco_torch.ops import rollout_cuda as rc

from ._torch_export import CPU, gpr_to_numpy, jax_gpr, jax_gpr_members, jax_svgp, paths_to_numpy, svgp_to_numpy, t

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
import run_torch  # noqa: E402

torch.set_num_threads(1)

ACTIVE = (1,)
D, DE, ACTION_SCALE, NUM_STEPS = 4, 5, 10.0, 7
S, B, M, MP = 64, 32, 24, 12
# JAX's kernel restatement uses the Abramowitz-Stegun normal CDF (max error
# 1.5e-7), the port the exact one. Measured over these 7 steps, per particle,
# relative to the loss's scale: median 7.5e-8 (cartpole), 2.1e-7 (LCK),
# 2.0e-7 (GPR); max 6.6e-6, 6.6e-4, 1.2e-3, where a few particles amplify it.
# With the A-S CDF in the port's place the two agree to 3e-14, 1.5e-12 and
# 1.9e-12.
AS_MEDIAN_BAR, AS_MAX_BAR = 1e-6, 5e-3


def _task(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(DE, DE))
    return np.array([1.0, 0.0, 0.3, 0.0, 0.0]), 0.1 * a @ a.T + np.eye(DE)


def _gentle(drift):
    """The drift's function scaled down, so 7 steps stay near x0."""
    if isinstance(drift, JaxGPR):
        return dataclasses.replace(drift, y=0.3 * drift.y)
    return dataclasses.replace(drift, q_mu=0.3 * drift.q_mu)


def _jax_case(name, seed=11):
    """(drift, policy, paths, x0, target, precis), JAX models and paths in
    float64: the cartpole shape (4 drift latents, 1 policy latent), the LCK
    shape (3 drift latents mixed into 4 outputs, 2 policy latents mixed into
    a 2-D action) or an exact GPR drift (4 outputs)."""
    key = jax.random.PRNGKey(seed)
    if name == "lck":
        drift = _gentle(jax_svgp(seed, num_latent=3, m=M, d=DE + 2, num_out=D))
        drift = dataclasses.replace(drift, w=0.5 * drift.w)
        policy = jax_svgp(seed + 1, num_latent=2, m=MP, d=DE, num_out=2)
    else:
        if name == "gpr":
            drift = _gentle(jax_gpr(seed, n=M, d=DE + 1, p=D))
        else:
            drift = _gentle(jax_svgp(seed, num_latent=D, m=M, d=DE + 1))
        policy = jax_svgp(seed + 1, num_latent=1, m=MP, d=DE)
    gen = jax_generate_paths_gpr if name == "gpr" else jax_generate_paths_svgp
    paths = gen(drift, key, S, B)
    x0 = np.pi * np.eye(D)[1] + 0.3 * np.random.default_rng(seed).normal(size=(S, D))
    return (drift, policy, paths, x0, *_task(seed))


def _jax_unfused_loss(policy, drift, paths, x0, target, precis):
    """Per-particle loss of the JAX package's per-step composition."""
    encoder = JaxEncoder(transform=JaxSinCos(), active_dims=ACTIVE)
    objective = JaxGaussianObjective(target=jnp.asarray(target), precis=jnp.asarray(precis))
    pol = JaxChain(
        JaxSquashedProbit(scale=jnp.asarray(2.0 * ACTION_SCALE - 1e-5)),
        JaxSVGPTransform(model=policy, deterministic=True).with_cache(),
    )
    cls = JaxPathwiseGPRTransform if isinstance(drift, JaxGPR) else JaxPathwiseSVGPTransform
    drift_fn = cls(model=drift, paths=paths)
    _, loss, _ = jax_euler_rollout(
        lambda tt, x: jax_forward_concrete(x, drift_fn, policy=pol, encoder=encoder),
        jnp.asarray(x0), dt=1.0, num_steps=NUM_STEPS,
        accumulate=lambda tt, x, acc: acc + objective(encoder(x)),
        acc_init=jnp.zeros((x0.shape[0],)),
    )
    return loss


@jax.jit
def _jax_loss_and_grad(policy, drift, paths, x0, target, precis):
    """The per-particle loss and the mean loss's gradient in (raw
    lengthscales, z, q_mu)."""

    def mean_loss(raw_ls, z, q_mu):
        kern = dataclasses.replace(policy.kernel, raw_lengthscales=raw_ls)
        pm = dataclasses.replace(policy, z=z, q_mu=q_mu, kernel=kern)
        per = _jax_unfused_loss(pm, drift, paths, x0, target, precis)
        return per.mean(), per

    (_, per), grads = jax.value_and_grad(mean_loss, argnums=(0, 1, 2), has_aux=True)(
        policy.kernel.raw_lengthscales, policy.z, policy.q_mu)
    return per, grads


def _torch_models(drift, policy, paths):
    if isinstance(drift, JaxGPR):
        tdrift = gpr_from_numpy(gpr_to_numpy(drift), CPU, torch.float64)
    else:
        tdrift = svgp_from_numpy(svgp_to_numpy(drift), CPU, torch.float64)
    tpol = svgp_from_numpy(svgp_to_numpy(policy), CPU, torch.float64)
    policy_mask(tpol)
    return tdrift.requires_grad_(False), tpol, paths_from_numpy(paths_to_numpy(paths), CPU, torch.float64)


def _torch_loss(tpol, tdrift, tpaths, x0, target, precis, reference=False):
    """Through the op (its hand adjoint), or with ``reference`` through the
    plain forward and autograd."""
    if not reference:
        return pathwise_rollout_loss_fused(
            tpol, tdrift, tpaths, t(x0), active_dims=ACTIVE, action_scale=ACTION_SCALE,
            target=t(target), precis=t(precis), dt=1.0, num_steps=NUM_STEPS,
        )
    meta, ops = fused_rollout_operands(
        tpol, tdrift, tpaths, state_dim=D, active_dims=ACTIVE, action_scale=ACTION_SCALE,
        target=t(target), precis=t(precis), dt=1.0, num_steps=NUM_STEPS,
    )
    return rc.rollout_reference(meta, t(x0), *ops)


def _policy_grad(tpol):
    g = [tpol.kernel.raw_lengthscales.grad, tpol.z.grad, tpol.q_mu.grad]
    out = np.concatenate([a.numpy().ravel() for a in g])
    tpol.zero_grad(set_to_none=True)
    return out


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", ["cartpole", "lck", "gpr"])
def test_torch_rollout_plain_matches_jax_unfused(name):
    """(a) The plain forward against the JAX unfused composition: the
    per-particle loss to 1e-10 of its scale, the policy gradient (through
    autograd of the plain forward and through the hand adjoint) to
    cos >= 0.9999999 with the norm to 1e-8."""
    drift, policy, paths, x0, target, precis = _jax_case(name)
    want, grads = _jax_loss_and_grad(policy, drift, paths, x0, target, precis)
    want = np.asarray(want)
    want_g = np.concatenate([np.asarray(g).ravel() for g in grads])
    tdrift, tpol, tpaths = _torch_models(drift, policy, paths)
    for reference in (True, False):
        loss = _torch_loss(tpol, tdrift, tpaths, x0, target, precis, reference=reference)
        assert _rel(loss.detach().numpy(), want) <= 1e-10
        loss.mean().backward()
        got_g = _policy_grad(tpol)
        assert np.linalg.norm(want_g) > 0
        assert _cos(got_g, want_g) >= 0.9999999, (reference, _cos(got_g, want_g))
        assert abs(np.linalg.norm(got_g) / np.linalg.norm(want_g) - 1.0) <= 1e-8


def _as_ndtr(x):
    """The Abramowitz-Stegun 7.1.26 normal CDF of the TPU kernel."""
    z = x * 2.0**-0.5
    az = z.abs()
    q = 1.0 / (1.0 + 0.3275911 * az)
    poly = q * (0.254829592 + q * (-0.284496736 + q * (1.421413741 + q * (-1.453152027 + q * 1.061405429))))
    erf = 1.0 - poly * torch.exp(-az * az)
    return 0.5 * (1.0 + torch.where(z < 0.0, -erf, erf))


@pytest.mark.parametrize("name", ["cartpole", "lck", "gpr"])
def test_torch_rollout_plain_vs_jax_kernel_restatement(name, monkeypatch):
    """(b) The plain forward against JAX's ``_interpret_reference`` (the TPU
    kernel's math): with the TPU kernel's approximate normal CDF in place of
    the exact one they agree to 1e-10 of the loss's scale; with the exact
    one they differ by the approximation alone, within AS_MEDIAN_BAR (the
    median particle) and AS_MAX_BAR (the worst) of the scale."""
    drift, policy, paths, x0, target, precis = _jax_case(name)
    want = np.asarray(jax.jit(functools.partial(
        jax_rollout.pathwise_rollout_loss_fused, active_dims=ACTIVE, action_scale=ACTION_SCALE,
        dt=1.0, num_steps=NUM_STEPS, reference=True,
    ))(policy, drift, paths, jnp.asarray(x0), target=jnp.asarray(target), precis=jnp.asarray(precis)))
    tdrift, tpol, tpaths = _torch_models(drift, policy, paths)
    with torch.no_grad():
        got = _torch_loss(tpol, tdrift, tpaths, x0, target, precis, reference=True).numpy()
        monkeypatch.setattr(torch.special, "ndtr", _as_ndtr)
        got_as = _torch_loss(tpol, tdrift, tpaths, x0, target, precis, reference=True).numpy()
    assert _rel(got_as, want) <= 1e-10
    gap = np.abs(got - want) / np.max(np.abs(want))
    assert 0.0 < np.median(gap) <= AS_MEDIAN_BAR and np.max(gap) <= AS_MAX_BAR, (np.median(gap), np.max(gap))


def _random_operands(k, s, d, active, u, lp, ld, b, m, mp, seed):
    """A RolloutMeta and operands with trainable (zp, alpha, ilp), from numpy;
    a non-symmetric precision matrix."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: t(rng.normal(size=sh))  # noqa: E731
    de = 2 * len(active) + d - len(active)
    dxu = de + u
    meta = rc.RolloutMeta(num_steps=NUM_STEPS, dt=1.0, squash_scale=2.0 * ACTION_SCALE - 1e-5,
                          active_dims=active, state_dim=d, enc_dim=de, act_dim=u, num_latent=ld,
                          pol_latent=lp)
    zp = f(lp, mp, de).requires_grad_(True)
    alpha = (0.5 * f(lp, mp)).requires_grad_(True)
    ilp = t(rng.uniform(0.5, 1.5, size=(lp, de))).requires_grad_(True)
    zd = f(k, ld, m, dxu)
    a = rng.normal(size=(de, de))
    rest = (f(u, lp), 0.1 * f(u), f(k, ld, b, dxu), t(rng.uniform(0, 2 * np.pi, size=(k, ld, b))),
            t(rng.uniform(0.5, 1.5, size=(k, ld, dxu))), zd, (zd * zd).sum(-1), 0.05 * f(s, ld, b),
            0.05 * f(s, ld, m), 0.5 * f(d, ld), 0.01 * f(k, d), f(de),
            t(0.1 * a @ a.T + np.eye(de) + 0.05 * rng.normal(size=(de, de))))
    return meta, f(s, d), (zp, alpha, ilp), rest


def _op_loss(meta, x0, trainable, rest, fused):
    zp, alpha, ilp = trainable
    ops = (x0, zp, (zp * zp).sum(-1), alpha, ilp, *rest)
    return rc.FusedRolloutLoss.apply(meta, *ops) if fused else rc.rollout_reference(meta, *ops)


@pytest.mark.parametrize("k, s, d, active, u, lp, ld", [
    (1, S, 4, (1,), 1, 1, 4),      # cartpole
    (1, S, 4, (1,), 2, 2, 3),      # LCK
    (3, 36, 4, (1,), 1, 1, 4),     # three members
    (2, 14, 5, (3, 0), 2, 2, 5),   # active dims out of order
])
def test_torch_rollout_hand_adjoint_matches_autograd(k, s, d, active, u, lp, ld):
    """(c) FusedRolloutLoss on CPU tensors (the hand adjoint
    rollout_reference_bwd) against autograd through rollout_reference, for
    a weighted sum of the per-particle losses: values and the zp, alpha and
    ilp gradients to 1e-10 of their scale."""
    meta, x0, trainable, rest = _random_operands(k, s, d, active, u, lp, ld, B, M, MP, seed=s + d)
    weights = t(np.random.default_rng(k).uniform(size=s))
    out = {}
    for fused in (True, False):
        loss = _op_loss(meta, x0, trainable, rest, fused)
        out[fused] = (loss.detach(), *torch.autograd.grad((loss * weights).sum(), trainable))
    for got, want in zip(out[True], out[False]):
        assert float((got - want).abs().max()) <= 1e-10 * (1.0 + float(want.abs().max()))


def test_torch_rollout_frozen_guard():
    """(d) A gradient asked of x0, the paths, the drift, the mixing or the
    cost raises; the policy operands and zp2 do not."""
    meta, x0, trainable, rest = _random_operands(1, 8, 4, (1,), 1, 1, 4, B, M, MP, seed=3)
    _op_loss(meta, x0, trainable, rest, fused=True)  # zp2 follows zp: allowed
    for i in range(len(rest) + 1):
        frozen = [x0, *rest]
        frozen[i] = frozen[i].clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match="differentiates only the policy"):
            _op_loss(meta, frozen[0], trainable, tuple(frozen[1:]), fused=True)
    drift, policy, paths, x0n, target, precis = _jax_case("cartpole")
    tdrift, tpol, tpaths = _torch_models(drift, policy, paths)
    tdrift.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        _torch_loss(tpol, tdrift, tpaths, x0n, target, precis)


def test_torch_rollout_ragged_particle_count():
    """(e) S = 37, not a multiple of the kernel's 4-particle tile (and 3 x 13
    members): each particle's loss is its own, the same as in a call with
    more particles, and the hand adjoint holds there too."""
    meta, x0, trainable, rest = _random_operands(1, S, 4, (1,), 1, 1, 4, B, M, MP, seed=37)
    full = _op_loss(meta, x0, trainable, rest, fused=True).detach()
    s = 37
    cut = tuple(r[:s] if r.shape[0] == S else r for r in rest)  # w and v
    small = _op_loss(meta, x0[:s], trainable, cut, fused=True)
    assert small.shape == (s,)
    torch.testing.assert_close(small.detach(), full[:s], rtol=1e-13, atol=1e-15)
    got = torch.autograd.grad(small.sum(), trainable)
    want = torch.autograd.grad(_op_loss(meta, x0[:s], trainable, cut, fused=False).sum(), trainable)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-10 * (1.0 + float(w.abs().max()))


def _split_bwd(meta, traj, gl, zp, zp2, alpha, ilp, wp, mc_p, omega, phase, ild, zd, zd2, w, v, wd, mc_d,
               target, precis):
    """csrc/rollout.cu's backward restated in torch, phase by phase: (1)
    every step's drift Jacobians J_l, state map A_t^T, policy-latent map
    and cost term at once, from the trajectory alone; (2) the recurrence
    g_t = A_t^T (g_{t+1} + c_{t+1}) per particle, writing each step's
    policy-latent cotangent glat; (3) dalpha and dzp per slot of GRAD_ROWS
    rows in the kernel's (step-major) row order, the slots added in order,
    and dilp per particle summed over the particles."""
    steps, (s, d) = meta.num_steps, traj.shape[1:]
    k, de = omega.shape[0], meta.enc_dim
    per = s // k

    def rows(a):  # (T, S, ...) -> (K, T * per, ...)
        return a.reshape(steps, k, per, *a.shape[2:]).transpose(0, 1).reshape(k, steps * per, *a.shape[2:])

    def unrows(a):  # the inverse
        return a.reshape(k, steps, per, *a.shape[2:]).transpose(0, 1).reshape(steps, s, *a.shape[2:])

    x, x1 = rows(traj[:-1]), rows(traj[1:])
    w4, v4 = (rows(a.expand(steps, *a.shape)) for a in (w, v))
    # phase 1
    e = rc._encode(meta, x)
    es, kp, graw = rc._policy(e, zp, zp2, alpha, ilp, wp, mc_p)
    xu = torch.cat([e, meta.squash_scale * (torch.special.ndtr(graw) - 0.5)], dim=-1)
    proj, xs, kd = rc._drift_terms(xu, omega, phase, ild, zd, zd2)
    kv = kd * v4
    jac = (-torch.einsum("kplb,klbi->kpli", torch.sin(proj) * w4, omega)
           + (torch.einsum("kplm,klmi->kpli", kv, zd) - kv.sum(-1, keepdim=True) * xs) * ild[:, None])
    gmap = meta.dt * torch.einsum("kpli,dl->kpid", jac, wd)  # gxu = gmap y
    pd = meta.squash_scale * rc._INV_SQRT_2PI * torch.exp(-0.5 * graw * graw)
    mg = torch.einsum("kpud,kpu,ul->kpld", gmap[..., de:, :], pd, wp)  # glat = mg y
    a = kp * alpha
    h = torch.einsum("kplm,lmi->kpli", a, zp) - es * a.sum(-1, keepdim=True)  # ges = glat h
    ge = gmap[..., :de, :] + torch.einsum("kpli,li,kpld->kpid", h, ilp, mg)
    cols = rc._encode_bwd(meta, x[..., None, :].expand(*x.shape[:2], d, d), ge.transpose(-1, -2))
    amat = cols.transpose(-1, -2) + torch.eye(d, dtype=x.dtype)
    c, err = rc._cost(rc._encode(meta, x1), target, precis)
    glr = rows(gl.expand(steps, s))
    cterm = rc._encode_bwd(meta, x1, (glr * -c)[..., None] * (err @ (0.5 * (precis + precis.T))))
    amat, mg, cterm, he = unrows(amat), unrows(mg), unrows(cterm), unrows(h * e[..., None, :])
    # phase 2
    g = torch.zeros(s, d, dtype=x.dtype)
    glat = torch.empty(steps, s, alpha.shape[0], dtype=x.dtype)
    dilp_p = torch.zeros(s, *ilp.shape, dtype=x.dtype)
    for t in reversed(range(steps)):
        y = g + cterm[t]
        glat[t] = torch.einsum("sld,sd->sl", mg[t], y)
        dilp_p = dilp_p + glat[t][..., None] * he[t]
        g = torch.einsum("sij,sj->si", amat[t], y)
    # phase 3
    kp_r, es_r = (unrows(a).reshape(steps * s, *a.shape[2:]) for a in (kp, es))
    glat_r = glat.reshape(steps * s, -1)
    dzp, dal = [], []
    for r0 in range(0, steps * s, rc.GRAD_ROWS):
        sl = slice(r0, r0 + rc.GRAD_ROWS)
        kg = kp_r[sl] * glat_r[sl][..., None]
        p0, p1 = kg.sum(0), torch.einsum("rlm,rli->lmi", kg, es_r[sl])
        dal.append(p0)
        dzp.append(alpha[..., None] * (p1 - p0[..., None] * zp))
    return torch.stack(dzp).sum(0), torch.stack(dal).sum(0), dilp_p.sum(0)


@pytest.mark.parametrize("k, s, u, lp, ld, steps", [
    (1, S, 1, 1, 4, NUM_STEPS),   # cartpole
    (1, S, 2, 2, 3, NUM_STEPS),   # LCK
    (1, 37, 1, 1, 4, NUM_STEPS),  # ragged: 259 rows, not a multiple of GRAD_ROWS
    (8, S, 1, 1, 4, NUM_STEPS),   # 8 members of 8 particles
    (1, S, 1, 1, 4, 1),           # one step
])
def test_torch_rollout_bwd_step_split_matches_reference(k, s, u, lp, ld, steps):
    """The kernel's three-phase backward (_split_bwd) against the
    reverse-time adjoint rollout_reference_bwd on the same trajectory, in
    float64: dzp, dalpha and dilp to 1e-12 of each output's scale (the same
    terms summed in another order)."""
    meta, x0, trainable, rest = _random_operands(k, s, 4, (1,), u, lp, ld, B, M, MP, seed=s + 10 * k + steps)
    meta = meta._replace(num_steps=steps)
    zp, alpha, ilp = (a.detach() for a in trainable)
    ops = (zp, (zp * zp).sum(-1), alpha, ilp, *rest)
    with torch.no_grad():
        traj = rc._rollout(meta, x0, *ops)[1]
        gl = t(np.random.default_rng(s).uniform(size=s) / s)
        got = _split_bwd(meta, traj, gl, *ops)
        want = rc.rollout_reference_bwd(meta, traj, gl, *ops)
    for name, a, b in zip(("dzp", "dalpha", "dilp"), got, want):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-12 * scale, (name, float((a - b).abs().max()), scale)


def _lane_add(acc, terms, group):
    """csrc/rollout.cu's forward partition of a sum over the last axis of
    ``terms`` (..., n) into a particle's lanes' partials ``acc`` (..., L):
    lane j takes the groups of ``group`` adjacent columns g = j, j + L, ...
    in order, and within a group its columns in order. Columns past n are
    zero terms (their weights load as zero)."""
    n, lanes = terms.shape[-1], acc.shape[-1]
    rounds = -(-n // (lanes * group))
    cols = torch.nn.functional.pad(terms, (0, rounds * lanes * group - n))
    cols = cols.reshape(*terms.shape[:-1], rounds, lanes, group)
    for r in range(rounds):
        for q in range(group):
            acc = acc + cols[..., r, :, q]
    return acc


def _meet(acc):
    """A particle's lanes' partials (..., 32 W) meet: by __shfl_xor_sync at
    offsets 16, 8, 4, 2, 1 within each of its W warps (every lane ends with
    its warp's total), then the warps' totals added in warp order."""
    lane = torch.arange(32)
    acc = acc.reshape(*acc.shape[:-1], -1, 32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    total = acc[..., 0, 0]
    for w in range(1, acc.shape[-2]):
        total = total + acc[..., w, 0]
    return total


def _warp_rollout(meta, group, wpp, x0, zp, zp2, alpha, ilp, wp, mc_p, omega, phase, ild, zd, zd2, w, v, wd,
                  mc_d, target, precis):
    """csrc/rollout.cu's forward restated in torch: ``wpp`` warps a particle;
    the policy centers one a lane of each warp (m = j, j + 32, ...), each
    drift latent's bases and then its centers in groups of ``group`` columns
    into one partial a lane of the particle's 32 wpp lanes, the partials
    meeting by butterfly and then warp by warp; then the Euler step and the
    cost: after the steps, lane j takes steps j, j + 32, ... of the
    trajectory, and the lanes' sums meet by butterfly. (loss (S,),
    trajectory (T+1, S, D))."""
    k, s = omega.shape[0], x0.shape[0]
    x, w4, v4 = rc._by_member(k, x0, w, v)
    traj = [x]
    for _ in range(meta.num_steps):
        e = rc._encode(meta, x)
        _, kp, _ = rc._policy(e, zp, zp2, alpha, ilp, wp, mc_p)
        glat = _meet(_lane_add(torch.zeros(*kp.shape[:-1], 32, dtype=x0.dtype), kp * alpha, 1))
        xu = torch.cat([e, meta.squash_scale * (torch.special.ndtr(glat @ wp.T + mc_p) - 0.5)], dim=-1)
        proj, _, kd = rc._drift_terms(xu, omega, phase, ild, zd, zd2)
        acc = _lane_add(torch.zeros(*kd.shape[:-1], 32 * wpp, dtype=x0.dtype), torch.cos(proj) * w4, group)
        f_lat = _meet(_lane_add(acc, kd * v4, group))
        x = x + meta.dt * (f_lat @ wd.T + mc_d[:, None])
        traj.append(x)
    costs = torch.stack([rc._cost(rc._encode(meta, xt), target, precis)[0] for xt in traj[1:]], -1)
    loss = _meet(_lane_add(torch.zeros(*costs.shape[:-1], 32, dtype=x0.dtype), costs, 1))
    return loss.reshape(s), torch.stack(traj).reshape(meta.num_steps + 1, s, -1)


@pytest.mark.parametrize("group", [4, 2])  # 16 bytes of float32 and of float64 columns
@pytest.mark.parametrize("wpp", [2, 1])  # warps a particle: 2 at Dxu <= 8, 1 at DXU = 16
@pytest.mark.parametrize("k, s, u, lp, ld, b, m, mp", [
    (1, 16, 1, 1, 4, 70, 19, 40),      # cartpole; B, M ragged against groups and rounds; Mp > 32
    (3, 21, 2, 2, 3, 257, 33, 65),     # LCK, 3 members; a lane's extra round at B, M and Mp
    (2, 10, 1, 1, 4, 256, 128, 32),    # whole rounds everywhere
])
def test_torch_rollout_fwd_warp_partition_matches_reference(group, wpp, k, s, u, lp, ld, b, m, mp):
    """The forward kernel's lane-to-column partition and the order in which
    its partials meet (_warp_rollout), in float64, against the plain
    rollout_cuda._rollout: loss and trajectory to 1e-12 of their scale (the
    same terms summed in another order: every column is taken once; a
    missed or doubled column moves them by ~1e-2). Over 3 steps: at B=257
    these unscaled path weights make a drift that multiplies the rounding
    gap by ~10 a step (3e-15 after one step, 2e-12 after seven)."""
    meta, x0, trainable, rest = _random_operands(k, s, 4, (1,), u, lp, ld, b, m, mp, seed=b + m + mp)
    meta = meta._replace(num_steps=3)
    zp, alpha, ilp = (a.detach() for a in trainable)
    ops = (x0, zp, (zp * zp).sum(-1), alpha, ilp, *rest)
    with torch.no_grad():
        got, want = _warp_rollout(meta, group, wpp, *ops), rc._rollout(meta, *ops)
    for name, a, w in zip(("loss", "trajectory"), got, want):
        scale = float(w.abs().max())
        assert scale > 0 and float((a - w).abs().max()) <= 1e-12 * scale, (name, float((a - w).abs().max()), scale)


def test_torch_rollout_fwd_plan():
    """The forward's route and shared memory: the slice's float32 tables
    (Ld=4, B=1024, M=240, Dxu=6) resident, 4 x 7 x 1264 x 4 bytes; float64
    and Ld=8 in float32 through the ring of two 1024-column chunks; Dxu=10
    pads to 16 rows (512-column chunks in float64); each adds the exchange
    area between a particle's warps and the threads' weight streams. A
    route other than resident or ring raises before any dispatch."""
    x = rc.FWD_XCH_BYTES + rc.FWD_STREAM_SLOTS * 16 * 512  # 512 threads a block at Dxu <= 8
    meta = rc.RolloutMeta(num_steps=30, dt=0.05, squash_scale=19.99999, active_dims=(1,), state_dim=4,
                          enc_dim=5, act_dim=1, num_latent=4, pol_latent=1)
    assert rc.fwd_plan(meta, 1024, 240, torch.float32) == ("resident", x + 4 * 7 * 1264 * 4)
    assert rc.fwd_plan(meta, 1024, 240, torch.float64) == ("ring", x + 2 * 7 * 1024 * 8)
    assert rc.fwd_plan(meta._replace(num_latent=8), 1024, 240, torch.float32) == ("ring", x + 2 * 7 * 1024 * 4)
    assert rc.fwd_plan(meta, 1001, 237, torch.float32) == ("resident", x + 4 * 7 * (1004 + 240) * 4)
    wide = meta._replace(state_dim=6, enc_dim=8, act_dim=2, active_dims=(4, 0))
    x = rc.FWD_XCH_BYTES + rc.FWD_STREAM_SLOTS * 16 * 256  # 256 at DXU = 16
    assert rc.fwd_plan(wide, 30, 20, torch.float64) == ("resident", x + 4 * 17 * (30 + 20) * 8)
    assert rc.fwd_plan(wide, 1024, 240, torch.float64) == ("ring", x + 2 * 17 * 512 * 8)
    _, x0, trainable, rest = _random_operands(1, 8, 4, (1,), 1, 1, 4, B, M, MP, seed=5)
    zp, alpha, ilp = (a.detach() for a in trainable)
    with pytest.raises(ValueError, match="route"):
        rc._fwd(meta._replace(num_steps=2), x0, zp, (zp * zp).sum(-1), alpha, ilp, *rest, route="chunked")


def _loop(batch_size, **kw):
    return run_torch.build_loop(
        0, CPU, torch.float64, horizon=0.5,  # 5 steps
        policy_spec=PolicySpec(num_restarts=1, batch_size=batch_size, num_bases=16), **kw,
    )


@pytest.mark.parametrize("kind", ["svgp", "gpr", "ensemble"])
def test_torch_rollout_loop_fused_matches_per_step(kind):
    """(f) PathwisePILCO.policy_loss_fn with and without use_fused_rollout at
    one generator state (the same paths and x0): loss to 1e-10 relative,
    policy gradient to cos >= 0.9999999, under an SVGP drift, a GPR drift
    and a 3-member GPREnsemble (4 particles per member)."""
    loop = _loop(12)
    if kind == "svgp":
        drift = svgp_from_numpy(svgp_to_numpy(_gentle(jax_svgp(40, num_latent=D, m=8, d=DE + 1))),
                                CPU, torch.float64)
    elif kind == "gpr":
        drift = gpr_from_numpy(gpr_to_numpy(_gentle(jax_gpr(41, n=20, d=DE + 1, p=D))), CPU, torch.float64)
    else:
        members = jax_gpr_members(42, k=3, n=20, d=DE + 1, p=D)
        drift = gpr_ensemble_from_numpy(gpr_to_numpy(dataclasses.replace(members, y=0.3 * members.y)),
                                        CPU, torch.float64)
    drift.requires_grad_(False)
    pol = svgp_from_numpy(svgp_to_numpy(jax_svgp(43, num_latent=1, m=6, d=DE)), CPU, torch.float64)
    policy_mask(pol)
    out = {}
    for fused in (False, True):
        loop.use_fused_rollout = fused
        loss = loop.policy_loss_fn(pol, torch.Generator().manual_seed(5), drift=drift)
        loss.backward()
        out[fused] = (float(loss.detach()), _policy_grad(pol))
    assert loop._fused_rollout_eligible(drift.members if kind == "ensemble" else drift, pol)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert abs(l1 - l0) <= 1e-10 * abs(l0)
    assert _cos(g1, g0) >= 0.9999999, _cos(g1, g0)


def test_torch_rollout_loop_update_policy():
    """(g) A tiny float32 pathwise iteration with use_fused_rollout: random
    episode, drift fit, Adam policy update to a finite loss that moved the
    policy, and an episode whose model-predicted reward runs the op."""
    loop = run_torch.build_loop(
        7, CPU, torch.float32, horizon=0.8,
        drift_spec=DriftSpec(num_centers=8, max_iters=20, pad_data_multiple=0),
        policy_spec=PolicySpec(num_centers=5, step_limit=6, batch_size=10, num_bases=16,
                               num_restarts=1),
    )
    loop.use_fused_rollout = True
    loop.step()
    loop.update_dynamics()
    loop.policy_model = loop.build_policy()
    assert loop._fused_rollout_eligible(loop.drift_model, loop.policy_model)
    before = loop.policy_model.z.detach().clone()
    info = loop.update_policy()
    assert np.isfinite(info["loss"]) and info["skipped_steps"] == 0
    assert float((loop.policy_model.z.detach() - before).abs().max()) > 0
    ep = loop.step()
    assert np.isfinite(ep.metrics["eReward"])


def test_torch_rollout_eligibility():
    """(h) The cases of the JAX package's _fused_rollout_eligible: off by
    default; on for an SVGP drift with latents == state dims or a mixing
    matrix, and for a GPR with outputs == state dims; off under loss_dtype,
    a non-SinCos encoder, a non-Gaussian objective, a w=None SVGP with other
    latents, a GPR with other outputs, or another drift type."""
    loop = _loop(8)
    pol = svgp_from_numpy(svgp_to_numpy(jax_svgp(1, num_latent=1, m=6, d=DE)), CPU, torch.float64)
    svgp = svgp_from_numpy(svgp_to_numpy(jax_svgp(2, num_latent=D, m=6, d=DE + 1)), CPU, torch.float64)
    lck = svgp_from_numpy(svgp_to_numpy(jax_svgp(3, num_latent=3, m=6, d=DE + 1, num_out=D)), CPU,
                          torch.float64)
    three = svgp_from_numpy(svgp_to_numpy(jax_svgp(4, num_latent=3, m=6, d=DE + 1)), CPU, torch.float64)
    gpr = gpr_from_numpy(gpr_to_numpy(jax_gpr(5, n=10, d=DE + 1, p=D)), CPU, torch.float64)
    gpr3 = gpr_from_numpy(gpr_to_numpy(jax_gpr(6, n=10, d=DE + 1, p=3)), CPU, torch.float64)
    assert not loop.use_fused_rollout and not loop._fused_rollout_eligible(svgp, pol)
    loop.use_fused_rollout = True
    assert all(loop._fused_rollout_eligible(m, pol) for m in (svgp, lck, gpr))
    assert not any(loop._fused_rollout_eligible(m, pol) for m in (three, gpr3, pol.kernel))
    spec = loop.policy_spec
    loop.policy_spec = dataclasses.replace(spec, loss_dtype=torch.float64)
    assert not loop._fused_rollout_eligible(svgp, pol)
    loop.policy_spec = spec
    encoder, objective = loop.encoder, loop.objective
    loop.encoder = Encoder(transform=Identity(), active_dims=ACTIVE)
    assert not loop._fused_rollout_eligible(svgp, pol)
    loop.encoder, loop.objective = encoder, lambda x: -torch.sum(x * x, -1)
    assert not loop._fused_rollout_eligible(svgp, pol)
    loop.objective = objective
    assert loop._fused_rollout_eligible(svgp, pol)
