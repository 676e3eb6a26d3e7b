"""Training drivers: guarded Adam and L-BFGS over ``nn.Parameter`` lists
(counterpart of gpflowpilco_tpu/utils/optimizers.py).

Parameters are updated in place. Frozen parameters are the ones the caller
leaves out of ``params`` (see models/builders.py masks).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch


def make_policy_schedule(step_limit: int, initial_lr: float = 0.01, num_drops: int = 3):
    """lr / 10 at each third of the budget: a function of the applied-step count."""
    bounds = [int(k * step_limit // num_drops) for k in range(1, num_drops)]

    def schedule(count: int) -> float:
        return initial_lr * 0.1 ** sum(count >= b for b in bounds)

    return schedule


def _clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """Scale the gradients in place to global norm ``max_norm`` when above it."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    for g in grads:
        g.mul_(scale)


def adam_minimize(
    loss_fn: Callable[[], torch.Tensor],
    params: List[torch.Tensor],
    num_steps: int,
    learning_rate: float = 0.01,
    schedule: Optional[Callable[[int], float]] = None,
    global_clipnorm: Optional[float] = 1.0,
):
    """Minimize ``loss_fn()`` for ``num_steps`` Adam steps; returns
    (losses (num_steps,) numpy, number of skipped steps).

    Global-norm clip, then Adam, and a step whose gradients are not all
    finite is skipped: neither the parameters nor Adam's state or step count
    move, as under optax ``apply_if_finite``. ``schedule(count)`` gives the
    learning rate from the count of applied steps.
    """
    if schedule is None:
        schedule = lambda count: learning_rate  # noqa: E731
    opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    losses, applied, skipped = [], 0, 0
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=False)
        loss = loss_fn()
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        losses.append(loss.detach())
        if not bool(torch.stack([torch.isfinite(g).all() for g in grads]).all()):
            skipped += 1
            continue
        if global_clipnorm is not None:
            _clip_by_global_norm(grads, global_clipnorm)
        for group in opt.param_groups:
            group["lr"] = schedule(applied)
        opt.step()
        applied += 1
    return torch.stack(losses).cpu().numpy(), skipped


def lbfgs_minimize(
    loss_fn: Callable[[], torch.Tensor],
    params: List[torch.Tensor],
    max_iters: int = 1000,
    tol: float = 1e-6,
    memory_size: int = 20,
):
    """Full-batch L-BFGS with a strong-Wolfe line search; returns
    (final loss, iterations). Stops at ``max_iters`` or when the largest
    gradient entry falls to ``tol``."""
    opt = torch.optim.LBFGS(
        params,
        lr=1.0,
        max_iter=max_iters,
        history_size=memory_size,
        tolerance_grad=tol,
        line_search_fn="strong_wolfe",
    )

    def closure():
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        return loss

    opt.step(closure)
    with torch.no_grad():
        final = float(loss_fn())
    iters = opt.state[opt._params[0]].get("n_iter", 0)
    return final, int(iters)
