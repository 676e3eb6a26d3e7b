"""Hamiltonian Monte Carlo over GP hyperparameters, chains as a batch axis
(counterpart of gpflowpilco_tpu/models/hmc.py).

The sampled state is one flat (C, dim) tensor of unconstrained parameters,
C chains on the leading axis. ``log_prob_fn`` maps it to (C,) log
densities in one batched evaluation, and the gradient is
``torch.autograd.grad`` of their sum (the chains do not interact). Step-size
dual averaging (Nesterov 2009, Stan's constants) adapts on the cross-chain
mean acceptance; the trajectory length is either jittered per chain and
iteration, uniform over [1, num_leapfrog], or adapted by ChEES (Hoffman,
Radul and Sountsov 2021), whose signal is cross-chain means too.
Randomness comes from an explicit ``torch.Generator``.

As in the JAX package, the leapfrog is masked: a chain whose trajectory is
shorter than the longest holds its state through the remaining steps.
Here the integration stops after the iteration's longest trajectory
(``max(lengths)`` steps, read by one host synchronization per iteration)
instead of running all ``num_leapfrog``: a held step changes nothing, so the
samples are the same. The log density and gradient at the current state are
carried from the end of one iteration into the next, so each leapfrog step
costs one batched evaluation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    num_warmup: int = 500
    num_samples: int = 500
    num_leapfrog: int = 16
    init_step_size: float = 0.05
    target_accept: float = 0.8
    jitter_trajectory: bool = True
    # dual averaging constants (Stan defaults)
    da_gamma: float = 0.05
    da_t0: float = 10.0
    da_kappa: float = 0.75
    # "jitter" (uniform over [1, num_leapfrog]) or "chees" (adapted
    # integration time, capped at max_leapfrog steps)
    adapt_trajectory: str = "jitter"
    max_leapfrog: int = 64
    chees_lr: float = 0.025


class HMCResult(NamedTuple):
    samples: torch.Tensor  # (num_samples, C, dim)
    accept_prob: torch.Tensor  # (num_samples, C)
    step_size: torch.Tensor  # () adapted step size
    final_logp: torch.Tensor  # (C,)
    trajectory_length: torch.Tensor  # () adapted integration time


def _logp_and_grad(log_prob_fn: Callable, q: torch.Tensor):
    """(C,) log densities and their (C, dim) gradients, detached."""
    with torch.enable_grad():
        q = q.detach().requires_grad_(True)
        logp = log_prob_fn(q)
        (grad,) = torch.autograd.grad(logp.sum(), q)
    return logp.detach(), grad.detach()


def run_hmc(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    q_init: torch.Tensor,
    generator: torch.Generator,
    config: HMCConfig = HMCConfig(),
) -> HMCResult:
    """Sample from exp(log_prob_fn(q)) with q_init (C, dim) the chains'
    starting points; ``log_prob_fn`` takes (C, dim) to (C,)."""
    num_chains, dim = q_init.shape
    dtype, device = q_init.dtype, q_init.device
    chees = config.adapt_trajectory == "chees"
    num_lf = config.max_leapfrog if chees else config.num_leapfrog
    scalar = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
    rand = dict(generator=generator, dtype=dtype, device=device)

    def draw_lengths(tau, eps):
        """Active leapfrog steps per chain (C,): one shared ceil(h tau / eps)
        for ChEES (the chains stay in lockstep), per-chain uniform jitter
        otherwise."""
        if chees:
            h = torch.rand((), **rand)
            steps = torch.clamp(torch.ceil(h * tau / eps), 1, num_lf).to(torch.int64)
            return steps.expand(num_chains)
        if config.jitter_trajectory:
            return torch.randint(1, num_lf + 1, (num_chains,), generator=generator, device=device)
        return torch.full((num_chains,), num_lf, dtype=torch.int64, device=device)

    def hmc_step(q, logp, grad, eps, lengths):
        """One transition of every chain; returns the new state with its log
        density and gradient, the acceptance probabilities and the proposal
        (q, p) that ChEES reads."""
        p = torch.randn((num_chains, dim), **rand)
        u = torch.rand((num_chains,), **rand)
        h0 = logp - 0.5 * torch.sum(p * p, -1)
        qn, pn, lpn, gn = q, p, logp, grad
        for step in range(int(lengths.max())):
            active = (step < lengths)[:, None]
            p_half = pn + 0.5 * eps * gn
            q_new = qn + eps * p_half
            lp_new, g_new = _logp_and_grad(log_prob_fn, q_new)
            p_new = p_half + 0.5 * eps * g_new
            # inactive chains hold their state
            qn = torch.where(active, q_new, qn)
            pn = torch.where(active, p_new, pn)
            gn = torch.where(active, g_new, gn)
            lpn = torch.where(active[:, 0], lp_new, lpn)
        h1 = lpn - 0.5 * torch.sum(pn * pn, -1)
        log_accept = torch.clamp(h1 - h0, max=0.0)
        # NaN-safe: a non-finite proposal is rejected
        ok = torch.isfinite(h1)
        accept = torch.where(ok, torch.exp(log_accept), torch.zeros_like(h1))
        take = ok & (torch.log(u) < log_accept)
        col = take[:, None]
        return (torch.where(col, qn, q), torch.where(take, lpn, logp), torch.where(col, gn, grad),
                accept, qn, pn)

    def chees_grad(q, q_prop, p_prop, accept):
        """d ChEES / d tau (Hoffman et al. 2021, eq. 14) from cross-chain
        means only."""
        dq = q - q.mean(0)
        dqp = q_prop - q_prop.mean(0)
        delta = torch.sum(dqp * dqp, -1) - torch.sum(dq * dq, -1)
        dot = torch.sum(dqp * p_prop, -1)
        g = torch.mean(accept * delta * dot) / torch.clamp(torch.mean(accept), min=1e-6)
        return torch.where(torch.isfinite(g), g, torch.zeros_like(g))

    # ---- warmup: dual-averaged step size and, for ChEES, the trajectory time
    mu = math.log(10.0 * config.init_step_size)
    q = q_init.detach().clone()
    logp, grad = _logp_and_grad(log_prob_fn, q)
    log_eps_bar = scalar(math.log(config.init_step_size))
    h_bar = scalar(0.0)
    log_tau = torch.log(scalar(config.init_step_size * config.num_leapfrog))
    m_ad, v_ad = scalar(0.0), scalar(0.0)
    for it in range(config.num_warmup):
        eps = torch.exp(mu - math.sqrt(it + 1.0) / config.da_gamma * h_bar)
        lengths = draw_lengths(torch.exp(log_tau), eps)
        q_old = q
        q, logp, grad, accept, q_prop, p_prop = hmc_step(q, logp, grad, eps, lengths)
        t = it + 1.0 + config.da_t0
        h_bar = (1.0 - 1.0 / t) * h_bar + (config.target_accept - accept.mean()) / t
        log_eps = mu - math.sqrt(it + 1.0) / config.da_gamma * h_bar
        w = (it + 1.0) ** (-config.da_kappa)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        if chees:
            g = chees_grad(q_old, q_prop, p_prop, accept)
            m_ad = 0.9 * m_ad + 0.1 * g
            v_ad = 0.999 * v_ad + 0.001 * g * g
            mhat = m_ad / (1.0 - 0.9 ** (it + 1.0))
            vhat = v_ad / (1.0 - 0.999 ** (it + 1.0))
            log_tau = log_tau + config.chees_lr * mhat / (torch.sqrt(vhat) + 1e-8)
            # keep tau realizable: at most num_lf steps at the current eps
            log_tau = torch.minimum(torch.maximum(log_tau, torch.log(eps)), torch.log(num_lf * eps))
    eps_final = torch.exp(log_eps_bar)
    tau_final = torch.exp(log_tau) if chees else eps_final * config.num_leapfrog

    # ---- sampling
    samples, accepts = [], []
    for _ in range(config.num_samples):
        lengths = draw_lengths(tau_final, eps_final)
        q, logp, grad, accept, _, _ = hmc_step(q, logp, grad, eps_final, lengths)
        samples.append(q)
        accepts.append(accept)
    return HMCResult(
        samples=torch.stack(samples),
        accept_prob=torch.stack(accepts),
        step_size=eps_final,
        final_logp=logp,
        trajectory_length=tau_final,
    )
