"""Model summaries and phase timing (counterpart of gpflowpilco_tpu/utils/summary.py)."""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def module_summary(module: torch.nn.Module, name: str = "model") -> str:
    """Tabulate a module's parameters: path, shape, dtype, min/max/mean."""
    header = ("path", "shape", "dtype", "min", "max", "mean")
    rows = []
    for path, p in module.named_parameters():
        a = p.detach()
        stats = (
            (f"{float(a.min()):+.3e}", f"{float(a.max()):+.3e}", f"{float(a.mean()):+.3e}")
            if a.numel() else ("-", "-", "-")
        )
        rows.append((path, str(tuple(a.shape)), str(a.dtype).replace("torch.", ""), *stats))
    widths = [max(len(r[i]) for r in rows + [header]) for i in range(6)]
    lines = [f"{name} summary:", "  " + "  ".join(h.ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        lines.append("  " + "  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)


def log_module_summary(module, name: str = "model", log: Optional[logging.Logger] = None):
    (log or logger).info("\n%s", module_summary(module, name))


class PhaseTimer:
    """Accumulates wall-clock per named phase; with ``trace_dir`` each phase
    also writes a torch.profiler Chrome trace there."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.times = {}
        self.trace_dir = trace_dir

    @contextlib.contextmanager
    def phase(self, name: str):
        ctx = contextlib.nullcontext()
        if self.trace_dir:
            ctx = torch.profiler.profile(
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.trace_dir)
            )
        t0 = time.perf_counter()
        with ctx:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        return ", ".join(f"{k}={v:.2f}s" for k, v in self.times.items())
