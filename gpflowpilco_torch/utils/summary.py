"""Model summaries (counterpart of gpflowpilco_tpu/utils/summary.py; its
phase timer is ``utils/tracing.py``'s ``episode.*`` spans here)."""
from __future__ import annotations

import logging
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
