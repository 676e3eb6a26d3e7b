"""Peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet,
dense): the vector rates outside the tensor cores, since the port runs no
TF32, and the HBM3 bandwidth. Copied from ``chip_smoke.py``."""
from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(bytes_moved: float, ops: float, dtype: str):
    """Least time of work that moves ``bytes_moved`` over 3.35 TB/s and does
    ``ops`` operations at the peak vector rate of ``dtype``, whichever is
    larger: (ms, 'bytes' | 'operations')."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
