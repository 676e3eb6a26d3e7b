"""Training drivers: guarded Adam (single- and multi-start) and L-BFGS over
``nn.Parameter`` lists (counterpart of gpflowpilco_tpu/utils/optimizers.py).

Parameters are updated in place. Frozen parameters are the ones the caller
leaves out of ``params`` (see models/builders.py masks). Each Adam iteration
is a step record of ``utils/tracing.py`` (``opt.iter``), its loss, backward,
finiteness guard and update each a span.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from . import tracing


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


def _adam(params: List[torch.Tensor], schedule: Callable[[int], float]) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)


def _guarded_step(opt, params, schedule, applied: int, global_clipnorm: Optional[float]) -> bool:
    """Clip the gradients in ``p.grad`` and apply one Adam step at the
    learning rate of ``applied`` applied steps. A step whose gradients are
    not all finite is skipped: neither the parameters nor Adam's state or
    step count move, as under optax ``apply_if_finite``. Returns whether the
    step was applied."""
    with tracing.span("opt.guard"):
        grads = [p.grad for p in params if p.grad is not None]
        if not tracing.host_sync("guard", torch.stack([torch.isfinite(g).all() for g in grads]).all()):
            return False
    with tracing.span("opt.update"):
        if global_clipnorm is not None:
            _clip_by_global_norm(grads, global_clipnorm)
        for group in opt.param_groups:
            group["lr"] = schedule(applied)
        opt.step()
    return True


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
    finite is skipped (``_guarded_step``). ``schedule(count)`` gives the
    learning rate from the count of applied steps.
    """
    if schedule is None:
        schedule = lambda count: learning_rate  # noqa: E731
    opt = _adam(params, schedule)
    losses, applied, skipped = [], 0, 0
    iteration = tracing.step("opt.iter")
    for _ in range(num_steps):
        with iteration:
            opt.zero_grad(set_to_none=False)
            with tracing.span("opt.loss"):
                loss = loss_fn()
                losses.append(loss.detach())
            with tracing.span("opt.backward"):
                loss.backward()
            if _guarded_step(opt, params, schedule, applied, global_clipnorm):
                applied += 1
            else:
                skipped += 1
    return torch.stack(losses).cpu().numpy(), skipped


def adam_minimize_multistart(
    loss_fns: Sequence[Callable[[], torch.Tensor]],
    params: Sequence[List[torch.Tensor]],
    num_steps: int,
    learning_rate: float = 0.01,
    schedule: Optional[Callable[[int], float]] = None,
    global_clipnorm: Optional[float] = 1.0,
):
    """K-candidate Adam: ``loss_fns[i]()`` is candidate i's loss over its
    parameters ``params[i]``. Returns (bests: per candidate, clones of its
    best-seen parameters; best losses (K,) numpy; losses (K, num_steps)
    numpy; skipped steps summed over the candidates).

    The candidates run one after another, each with its own Adam state,
    clip, non-finite skip and schedule count, as ``adam_minimize``; the
    caller gives each its own randomness. Each returns its BEST-SEEN
    parameters and loss, not its final ones: the loss of a step belongs to
    the parameters that enter that step, a NaN loss never counts as better,
    and the best loss (and the trace) is kept in the parameters' dtype, even
    when the loss runs wider (``PolicySpec.loss_dtype``). The best loss and
    parameters stay on the device, updated by ``torch.where``, so the
    tracking adds no host sync. The parameters are left at their final
    values. There is no ``chunk_size``: the JAX runner's chunks bound
    ``lax.scan`` dispatches, which eager PyTorch does not have.
    """
    if schedule is None:
        schedule = lambda count: learning_rate  # noqa: E731
    bests, best_losses, traces, skipped = [], [], [], 0
    for k, (loss_fn, cand) in enumerate(zip(loss_fns, params)):
        opt = _adam(cand, schedule)
        best = [p.detach().clone() for p in cand]
        best_loss = torch.full((), math.inf, dtype=cand[0].dtype, device=cand[0].device)
        losses, applied = [], 0
        iteration = tracing.step("opt.iter", candidate=k)
        for _ in range(num_steps):
            with iteration:
                opt.zero_grad(set_to_none=False)
                with tracing.span("opt.loss"):
                    loss = loss_fn()
                with tracing.span("opt.backward"):
                    loss.backward()
                loss = loss.detach().to(best_loss.dtype)
                losses.append(loss)
                better = loss < best_loss  # NaN < x is False
                best_loss = torch.where(better, loss, best_loss)
                best = [torch.where(better, p.detach(), b) for p, b in zip(cand, best)]
                if _guarded_step(opt, cand, schedule, applied, global_clipnorm):
                    applied += 1
                else:
                    skipped += 1
        bests.append(best)
        best_losses.append(best_loss)
        traces.append(torch.stack(losses))
    return (
        bests,
        torch.stack(best_losses).cpu().numpy(),
        torch.stack(traces).cpu().numpy(),
        skipped,
    )


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
