"""Plain PyTorch reference of one pathwise policy-optimisation step.

It restates, from the equations and with no code of the measured package,
what a step of the policy update does:

  paths   f_s(x) = sqrt(2 var / B) sum_b w_sb cos(omega_b . x + phi_b)
                   + var sum_m exp(-|x - z_m|^2 / 2 ls^2) v_sm,
          omega_b = N(0, I) / ls, v_s = Kuu^-1 (Luu (q_mu + q_sqrt eps_s) - f_prior_s(Z))
  policy  u = s (Phi(k(e, Zp) Luu_p^-T q_mu_p var_p Wp' + mc_p) - 1/2), s = 2 scale - 1e-5
  rollout e = [sin x_a, cos x_a, x_rest], x <- x + f([e, u]) Wd' + mc_d,
          loss = mean_s sum_t -exp(-(e_{t+1} - target)' P (e_{t+1} - target) / 2)
  update  clip the gradient of the policy's raw leaves to global norm 1, then Adam

The random draws replay the measured step's protocol from the same
generator seed: per step the frequencies' normals (L, B, Dxu), the phases'
uniforms (L, B), the bases' weights (S, L, B), the inducing normals (S, L, M)
and the initial states' normals (S, D), in that order and in the cell's
dtype. Everything else is computed in ``dtype`` (float64 for the truth), the
Cholesky factors in ``factor_dtype``.

Where a rollout is chaotic, the gradient of the mean cost is dominated by a
few particles whose trajectories rounding alone moves: the reference moved
by one unit in the last place departs from itself there. ``kept_particles``
runs the first step twice, on the same paths, from the initial states and
from its **twin**, the same states times ``1 + eps``, and keeps the
particles whose state stays within a relative gap ``tau`` of the twin's at
every step. ``reference_steps(kept=...)`` then also gives the raw gradient
(before the clip) of the kept particles' mean cost, one backward with the
cotangent ``kept / n_kept`` on the first step's per-particle costs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

LEAVES = ("raw_lengthscales", "z", "q_mu")  # the policy's trainable leaves
BETAS, EPS = (0.9, 0.999), 1e-8


def positive(raw):
    return torch.nn.functional.softplus(raw) + 1e-6


def sigmoid_interval(raw, low, high):
    return low + (high - low) / (1.0 + torch.exp(-raw))


def encode(x, active):
    """[sin x_a, cos x_a, x_rest] along the last axis."""
    rest = [i for i in range(x.shape[-1]) if i not in active]
    xa = x[..., list(active)]
    return torch.cat([torch.sin(xa), torch.cos(xa), x[..., rest]], dim=-1)


def scaled_sqdist(a, b, ls):
    """|a/ls - b/ls|^2: a (..., N, D), b (L, M, D), ls (L, D) -> (..., L, N, M),
    by the direct difference."""
    sa = a[..., None, :, :] / ls[:, None, :]
    sb = b / ls[:, None, :]
    diff = sa[..., :, None, :] - sb[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def gram_same(z, ls):
    """exp(-|z_i/ls - z_j/ls|^2 / 2) per latent: z (L, M, D), ls (L, D) -> (L, M, M)."""
    sz = z / ls[:, None, :]
    diff = sz[:, :, None, :] - sz[:, None, :, :]
    return torch.exp(-0.5 * torch.sum(diff * diff, dim=-1))


def _factor(k, jitter, factor_dtype, dtype):
    eye = torch.eye(k.shape[-1], dtype=factor_dtype, device=k.device)
    return torch.linalg.cholesky(k.to(factor_dtype) + jitter * eye).to(dtype)


def draw_step(gen, cfg, dtype, device):
    """One step's draws in the measured step's order, in ``dtype``."""
    d, s, b = cfg["state_dim"], cfg["particles"], cfg["bases"]
    lat, m = cfg["drift"]["num_latent"], cfg["drift"]["num_inducing"]
    dxu = 2 * len(cfg["active_dims"]) + d - len(cfg["active_dims"]) + cfg["action_dim"]
    kw = dict(generator=gen, dtype=dtype, device=device)
    return dict(
        omega_normal=torch.randn((lat, b, dxu), **kw),
        phase=2.0 * math.pi * torch.rand((lat, b), **kw),
        w=torch.randn((s, lat, b), **kw),
        eps=torch.randn((s, lat, m), **kw),
        rvs=torch.randn((s, d), **kw),
    )


def sample_paths(drift, draws, cfg, jitter, factor_dtype):
    """Frequencies, phases, prior weights (scaled) and update weights v (S, L, M)."""
    dc = cfg["drift"]
    ls = sigmoid_interval(drift["raw_lengthscales"], dc["ls_low"], dc["ls_high"])  # (L, Dxu)
    var = positive(drift["raw_variance"])  # (L,)
    z = drift["z"]  # (L, M, Dxu)
    b = draws["omega_normal"].shape[1]
    omega = draws["omega_normal"] / ls[:, None, :]
    phase = draws["phase"]
    kuu = var[:, None, None] * gram_same(z, ls)
    luu = _factor(kuu, jitter, factor_dtype, z.dtype)
    u = drift["q_mu"].T[None] + torch.einsum("lmn,sln->slm", torch.tril(drift["q_sqrt"]), draws["eps"])
    u = torch.einsum("lmn,sln->slm", luu, u)  # whitened: u = Luu v
    amp = torch.sqrt(2.0 * var / b)  # (L,)
    feats = amp[:, None, None] * torch.cos(torch.einsum("lmd,lbd->lmb", z, omega) + phase[:, None, :])
    resid = u - torch.einsum("lmb,slb->slm", feats, draws["w"])
    v = torch.cholesky_solve(resid.permute(1, 2, 0), luu).permute(2, 0, 1)  # (S, L, M)
    return dict(omega=omega, phase=phase, w=amp[None, :, None] * draws["w"], v=v, ls=ls, var=var,
                z=z)


def policy_weights(policy, cfg, jitter, factor_dtype):
    """(alpha (Lp, Mp), ls (Lp, De)): the deterministic mean's weights
    var Luu^-T q_mu (whitened)."""
    pc = cfg["policy"]
    ls = sigmoid_interval(policy["raw_lengthscales"], pc["ls_low"], pc["ls_high"])
    var = positive(policy["raw_variance"])
    z = policy["z"]
    kuu = var[:, None, None] * gram_same(z, ls)
    luu = _factor(kuu, jitter, factor_dtype, z.dtype)
    q_mu = policy["q_mu"].T[..., None]  # (Lp, Mp, 1)
    alpha = torch.linalg.solve_triangular(luu.mT, q_mu, upper=True)[..., 0]
    return var[:, None] * alpha, ls


def rollout_costs(policy, drift, paths, x0, cfg, jitter, factor_dtype, num_steps, states=None,
                  detach_last=False):
    """Per-particle cumulative cost (S,). A list ``states`` receives each
    step's state (S, D). ``detach_last`` is a fault for the checks: the last
    transition reads its input state detached, which leaves the forward bit
    for bit as it is and cuts that transition out of the backward."""
    active = tuple(cfg["active_dims"])
    scale = 2.0 * cfg["action_scale"] - 1e-5
    target = torch.as_tensor(cfg["target"], dtype=x0.dtype, device=x0.device)
    precis = torch.as_tensor(cfg["precis"], dtype=x0.dtype, device=x0.device)
    alpha, ls_p = policy_weights(policy, cfg, jitter, factor_dtype)
    wp, mc_p = policy.get("w"), policy["mean_const"]
    wd, mc_d = drift.get("w"), drift["mean_const"]
    x, cost = x0, torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    for t in range(num_steps):
        e = encode(x.detach() if detach_last and t == num_steps - 1 else x, active)
        kp = torch.exp(-0.5 * scaled_sqdist(e, policy["z"], ls_p))  # (Lp, S, Mp)
        g = torch.einsum("lsm,lm->sl", kp, alpha)
        g = (g if wp is None else g @ wp.T) + mc_p
        xu = torch.cat([e, scale * (torch.special.ndtr(g) - 0.5)], dim=-1)
        proj = torch.einsum("sd,lbd->slb", xu, paths["omega"]) + paths["phase"]
        f = torch.sum(torch.cos(proj) * paths["w"], dim=-1)  # (S, L)
        kd = torch.exp(-0.5 * scaled_sqdist(xu, paths["z"], paths["ls"]))  # (L, S, M)
        f = f + paths["var"] * torch.einsum("lsm,slm->sl", kd, paths["v"])
        x = x + ((f if wd is None else f @ wd.T) + mc_d)
        if states is not None:
            states.append(x.detach())
        err = encode(x, active) - target
        cost = cost - torch.exp(-0.5 * torch.sum(err * (err @ precis.T), dim=-1))
    return cost


def cast(params: Dict[str, torch.Tensor], dtype) -> Dict[str, Optional[torch.Tensor]]:
    return {k: None if v is None else v.detach().to(dtype).clone() for k, v in params.items()}


def step_operands(gen, cfg, drift, draw_dtype, dtype, jitter, factor_dtype):
    """One step's paths and initial states (S, D) from the generator, in ``dtype``."""
    device = drift["z"].device
    draws = {k: v.to(dtype) for k, v in draw_step(gen, cfg, draw_dtype, device).items()}
    with torch.no_grad():
        paths = sample_paths(drift, draws, cfg, jitter, factor_dtype)
    mean = torch.as_tensor(cfg["state_mean"], dtype=dtype, device=device)
    tril = torch.as_tensor(cfg["state_scale_tril"], dtype=dtype, device=device)
    return paths, mean + draws["rvs"] @ tril.T


def num_rollout_steps(cfg: dict) -> int:
    return int(math.ceil(cfg["horizon"] / cfg["step_size"]))


def twin(x0: torch.Tensor) -> torch.Tensor:
    """The initial states moved by one unit in the last place of their dtype."""
    return x0 * (1.0 + torch.finfo(x0.dtype).eps)


def twin_gaps(cfg: dict, drift: Dict[str, torch.Tensor], policy: Dict[str, torch.Tensor],
              step_seed: int, draw_dtype: torch.dtype, jitter: float,
              eps: Optional[float] = None) -> torch.Tensor:
    """Per particle (S,), the largest relative gap over the first step's
    rollout between the reference's state and its twin's, from the initial
    states times ``1 + eps`` (one unit in the last place of float64 by
    default) on the same paths: max over t of |x_t - x'_t| / max(|x'_t|, 1),
    norms over the state. In float64."""
    f64 = torch.float64
    dr, po = cast(drift, f64), cast(policy, f64)
    gen = torch.Generator(device=po["z"].device).manual_seed(step_seed)
    with torch.no_grad():
        paths, x0 = step_operands(gen, cfg, dr, draw_dtype, f64, jitter, f64)
        runs = []
        for start in (x0, twin(x0) if eps is None else x0 * (1.0 + eps)):
            runs.append([])
            rollout_costs(po, dr, paths, start, cfg, jitter, f64, num_rollout_steps(cfg), states=runs[-1])
        gaps = [torch.linalg.vector_norm(a - b, dim=-1) / torch.clamp(torch.linalg.vector_norm(b, dim=-1),
                                                                      min=1.0)
                for a, b in zip(*runs)]
    return torch.stack(gaps).amax(0)


def kept_particles(cfg: dict, drift: Dict[str, torch.Tensor], policy: Dict[str, torch.Tensor],
                   step_seed: int, draw_dtype: torch.dtype, jitter: float, tau: float) -> torch.Tensor:
    """(S,) bool: the particles whose first-step rollout stays within ``tau``
    of its one-ulp twin's at every step (``twin_gaps``)."""
    return twin_gaps(cfg, drift, policy, step_seed, draw_dtype, jitter) <= tau


def reference_steps(cfg: dict, drift: Dict[str, torch.Tensor], policy: Dict[str, torch.Tensor],
                    step_seed: int, num_steps: int, draw_dtype: torch.dtype, dtype: torch.dtype,
                    jitter: float, factor_dtype: Optional[torch.dtype] = None,
                    half_batch: bool = False, kept: Optional[torch.Tensor] = None,
                    detach_last: bool = False, nudge: bool = False) -> dict:
    """Follow the policy update's first ``num_steps`` steps from the given raw
    parameters. Returns the losses, the first step's per-particle costs, its
    clipped gradient and the leaves' change after it, and their change after
    the last step, each leaf by name; with ``kept`` (S,) also the first
    step's raw gradient of the kept particles' mean cost (``grad_kept``) and
    their share. ``half_batch`` and ``detach_last`` are faults for the
    checks: the mean over the first half of the particles, and the last
    transition cut out of the backward (``rollout_costs``). ``nudge`` starts
    every step from its initial states' twin: the reference's own spread
    under chaos, a witness for the numbers the program reads."""
    factor_dtype = factor_dtype or dtype
    device = policy["z"].device
    dr, po = cast(drift, dtype), cast(policy, dtype)
    leaves = [po[name].requires_grad_(True) for name in LEAVES]
    start = [t.detach().clone() for t in leaves]
    num_rollout = num_rollout_steps(cfg)
    gen = torch.Generator(device=device).manual_seed(step_seed)
    m1 = [torch.zeros_like(t) for t in leaves]
    m2 = [torch.zeros_like(t) for t in leaves]
    losses: List[float] = []
    first_grad = first_costs = change_first = grad_kept = None
    for step in range(num_steps):
        paths, x0 = step_operands(gen, cfg, dr, draw_dtype, dtype, jitter, factor_dtype)
        costs = rollout_costs(po, dr, paths, twin(x0) if nudge else x0, cfg, jitter, factor_dtype, num_rollout,
                              detach_last=detach_last)
        if half_batch:
            costs = costs[: costs.shape[0] // 2]
        if first_costs is None:
            first_costs = costs.detach().to(torch.float64)
            if kept is not None:
                mask = kept[: costs.shape[0]].to(dtype)
                grad_kept = torch.autograd.grad(costs, leaves, mask / mask.sum(), retain_graph=True)
        loss = costs.mean()
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            clip = min(1.0, cfg["global_clipnorm"] / float(norm))
            grads = [g * clip for g in grads]
            if first_grad is None:
                first_grad = [g.clone() for g in grads]
            lr = cfg["learning_rate"]  # the schedule's first drop is at a third of step_limit
            for t, g, a, b2 in zip(leaves, grads, m1, m2):
                a.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                b2.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                c1, c2 = 1 - BETAS[0] ** (step + 1), 1 - BETAS[1] ** (step + 1)
                t.sub_(lr / c1 * a / (torch.sqrt(b2) / math.sqrt(c2) + EPS))
            if step == 0:
                change_first = {name: (t.detach() - t0).to(torch.float64)
                                for name, t, t0 in zip(LEAVES, leaves, start)}
    out = dict(
        losses=losses,
        costs=first_costs,
        grad={name: g.to(torch.float64) for name, g in zip(LEAVES, first_grad)},
        change_first=change_first,
        change={name: (t.detach() - t0).to(torch.float64)
                for name, t, t0 in zip(LEAVES, leaves, start)},
    )
    if kept is not None:
        out.update(grad_kept={name: g.to(torch.float64) for name, g in zip(LEAVES, grad_kept)},
                   kept_share=float(kept.to(torch.float64).mean()))
    return out
