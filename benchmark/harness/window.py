"""Drive the port's own Adam loop over the cell's loss and time its steps.

``utils/optimizers.adam_minimize`` runs as ``PILCOBase.update_policy`` runs
it for one candidate; the harness owns the loss closure, which stamps each
step's start on the host clock. The guarded step waits for the device once
a step, so the interval between two stamps is a step's time. Warm-up is
set-up: at least ``warmup_steps`` steps and ``warmup_seconds`` of them, so
that the host and the card reach the speed they hold; the window opens at
the next step's start and closes at the first step start ``seconds``
later, which the closure refuses by raising. A global optimizer hook finds
the optimizer the loop made and counts the steps it applied (a step the
guard skipped for non-finite gradients applies none). ``counters`` are the
program's launch-count dicts; the window keeps how far each key moved
between its open and its close (``launches_in_window``).

For the comparison the window keeps the first ``checked_steps`` losses, the
first step's per-particle costs as the variant's ``costs`` function
returned them, the optimizer's state and the leaves after the first step
and the leaves after the last checked one. Each of ``spans``, a variant's
``(owner, attribute, name)``, has its calls timed (host clock, around the
attribute the port calls through) into ``self.spans[name]``; with
``profile_steps`` the window runs that many more steps after it under
``torch.profiler`` (and one before them that warms the profiler), each
step (``step``), each such call (``name``) and the backward-and-update
interval (``backward_update``) in a ``record_function`` span.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from gpflowpilco_torch.utils.optimizers import adam_minimize

UPDATE_SPAN = "backward_update"  # from the loss's return to the next step's start


class _Closed(Exception):
    """Raised by the closure to end the loop."""


class _Span:
    """A ``record_function`` span opened and closed by hand."""

    def __init__(self):
        self._open = None

    def start(self, name: str):
        self.stop()
        self._open = torch.profiler.record_function(name)
        self._open.__enter__()

    def stop(self):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


class StepWindow:
    def __init__(self, system, warmup_steps: int, checked_steps: int, seconds: float,
                 spans: Sequence[Tuple[object, str, str]] = (), costs: Optional[Tuple[object, str]] = None,
                 profile_steps: int = 0, warmup_seconds: float = 0.0,
                 counters: Sequence[Dict[str, int]] = ()):
        self.system = system
        self.warmup_steps = max(warmup_steps, checked_steps + 1)
        self.warmup_seconds = warmup_seconds
        self.counters = list(counters)
        self.launches_in_window: Dict[str, int] = {}
        self._counts_at_open: Dict[str, int] = {}
        self._first_call: Optional[float] = None
        self.checked_steps = checked_steps
        self.seconds = seconds
        self.wrapped = tuple(spans)
        self.costs = costs
        self.profile_steps = profile_steps
        self.calls = 0
        self.stamps: List[float] = []  # window steps' starts, then the closing call's
        self.returns: List[float] = []  # the window steps' closure returns
        self.spans: Dict[str, List[float]] = {name: [] for _, _, name in self.wrapped}
        self.window_open: Optional[float] = None
        self.applied_at_open = 0
        self.applied_in_window = 0
        self.applied = 0
        self.optimizer = None
        self.losses: List[torch.Tensor] = []
        self.first_costs: Optional[torch.Tensor] = None
        self.first_state = None
        self.start = [p.detach().clone() for p in system.params]
        self.after_first = None
        self.after_checked = None
        self.profiler = None
        self.profiled = 0
        self._step_span, self._inner_span = _Span(), _Span()
        self._in_window = False

    # -------------------------------------------------------------- hooks
    def _on_step(self, optimizer, args, kwargs):
        if any(p is self.system.params[0] for g in optimizer.param_groups for p in g["params"]):
            self.optimizer = optimizer
            self.applied += 1

    def _timed(self, fn, record: List[float], name: str):
        def wrapped(*args, **kwargs):
            if self.profiler is not None:
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if self._in_window:
                    record.append(time.perf_counter() - t0)
        return wrapped

    def _kept(self, fn):
        def wrapped(*args, **kwargs):
            costs = fn(*args, **kwargs)
            if self.calls == 1:
                self.first_costs = costs.detach().clone()
            return costs
        return wrapped

    def _counts(self) -> Dict[str, int]:
        return {k: v for c in self.counters for k, v in c.items()}

    # -------------------------------------------------------------- the closure
    def _state_of_first_step(self):
        opt = self.optimizer
        if opt is None:
            return [torch.zeros_like(p) for p in self.system.params]
        beta1 = opt.param_groups[0]["betas"][0]
        return [opt.state[p]["exp_avg"].detach().clone() / (1.0 - beta1) if "exp_avg" in opt.state[p]
                else torch.zeros_like(p) for p in self.system.params]

    def closure(self) -> torch.Tensor:
        now = time.perf_counter()
        self.calls += 1
        call = self.calls
        if call == 2:
            self.first_state = self._state_of_first_step()
            self.after_first = [p.detach().clone() for p in self.system.params]
        if call == self.checked_steps + 1:
            self.after_checked = [p.detach().clone() for p in self.system.params]
        if self._first_call is None:
            self._first_call = now
        if (self.window_open is None and call > self.warmup_steps
                and now - self._first_call >= self.warmup_seconds):
            self.window_open = now
            self.applied_at_open = self.applied
            self._counts_at_open = self._counts()
            self._in_window = True
        if self._in_window:
            self.stamps.append(now)
            if now - self.window_open >= self.seconds:
                self._in_window = False
                self.applied_in_window = self.applied - self.applied_at_open
                self.launches_in_window = {k: v - self._counts_at_open[k]
                                           for k, v in self._counts().items()}
                if not self.profile_steps:
                    raise _Closed
                self.profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                self.profiler.start()
        if self.profiler is not None:
            if self.profiled == self.profile_steps + 1:
                self._inner_span.stop()
                self._step_span.stop()
                if self.system.params[0].is_cuda:
                    torch.cuda.synchronize()
                self.profiler.stop()
                raise _Closed
            self.profiled += 1
            self._inner_span.stop()
            self._step_span.start("step")
        loss = self.system.loss()
        if call <= self.checked_steps:
            self.losses.append(loss.detach().clone())
        if self._in_window:
            self.returns.append(time.perf_counter())
        if self.profiler is not None:
            self._inner_span.start(UPDATE_SPAN)
        return loss

    def run(self):
        """Run the steps until the window (and the profiled slice) closes."""
        system, spec = self.system, self.system.loop.policy_spec
        handle = register_optimizer_step_post_hook(self._on_step)
        originals = {(owner, attr): getattr(owner, attr) for owner, attr, _ in self.wrapped}
        if self.costs is not None:
            owner, attr = self.costs
            originals.setdefault(self.costs, getattr(owner, attr))
            setattr(owner, attr, self._kept(getattr(owner, attr)))
        for owner, attr, name in self.wrapped:
            setattr(owner, attr, self._timed(getattr(owner, attr), self.spans[name], name))
        try:
            while True:  # a new update after step_limit steps
                adam_minimize(self.closure, system.params, num_steps=spec.step_limit,
                              schedule=system.schedule, global_clipnorm=spec.global_clipnorm)
        except _Closed:
            pass
        finally:
            for (owner, attr), fn in originals.items():
                setattr(owner, attr, fn)
            handle.remove()
            self._inner_span.stop()
            self._step_span.stop()

    # -------------------------------------------------------------- results
    @property
    def window_steps(self) -> int:
        """Steps begun and finished in the window."""
        return max(len(self.stamps) - 1, 0)

    @property
    def window_seconds(self) -> float:
        return self.stamps[-1] - self.stamps[0] if len(self.stamps) > 1 else float("nan")

    def intervals(self) -> List[float]:
        return [b - a for a, b in zip(self.stamps, self.stamps[1:])]

    def after_return(self) -> List[float]:
        """From each window step's loss return to the next step's start."""
        return [b - a for a, b in zip(self.returns, self.stamps[1:])]
