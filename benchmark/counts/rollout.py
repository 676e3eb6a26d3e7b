"""K6's least time per entry call, from its shapes: ``chip_smoke.py``'s
``rollout_bound_ms`` arithmetic, copied, on the shapes instead of the
operand tensors.

Each input is read once and each output written once; a cos, sin or exp
counts as one operation and an FMA as two. Per particle and step the
forward evaluates the policy and the drift's centers (per center the dot
with the pre-scaled center, the distance from the per-particle |x|^2 and the
pre-computed |z|^2, the exp and the weight: 2 Dxu + 8) and bases (the
projection, the phase, the cos and the weight: 2 Dxu + 4). The backward
needs per basis the projection, the phase, the sin, the coefficient and the
Dxu-term update (4 Dxu + 4), per drift center the distance, the exp, the
weighted gram and the Dxu-term update (4 Dxu + 8), and per policy center
the recomputed forward (2 De + 8) and its adjoint (4 De + 6).
"""
from __future__ import annotations

from .peaks import bound_ms

ELEM_BYTES = {"float32": 4, "float64": 8}


def operand_elems(n: dict, k: int = 1) -> int:
    """Elements of K6's operands (x0 first), in OPERANDS order."""
    s, d, de, u, dxu = n["S"], n["D"], n["De"], n["U"], n["Dxu"]
    ld, b, m, lp, mp = n["L"], n["B"], n["M"], n["Lp"], n["Mp"]
    return (s * d + lp * mp * de + lp * mp + lp * mp + lp * de + u * lp + u
            + k * ld * b * dxu + k * ld * b + k * ld * dxu + k * ld * m * dxu + k * ld * m
            + s * ld * b + s * ld * m + d * ld + k * d + de + de * de)


def small_ops(n: dict) -> int:
    """Encoder, Euler and cost per particle and step."""
    return 2 * n["D"] * n["L"] + 4 * n["De"] * n["De"] + 40


def fwd_ops(n: dict) -> int:
    """Operations of one forward entry call."""
    per = (n["Lp"] * n["Mp"] * (2 * n["De"] + 8) + n["L"] * n["B"] * (2 * n["Dxu"] + 4)
           + n["L"] * n["M"] * (2 * n["Dxu"] + 8) + small_ops(n))
    return n["T"] * n["S"] * per


def bwd_ops(n: dict) -> int:
    """Operations of one backward entry call."""
    per = (n["Lp"] * n["Mp"] * (6 * n["De"] + 14) + n["L"] * n["B"] * (4 * n["Dxu"] + 4)
           + n["L"] * n["M"] * (4 * n["Dxu"] + 8) + 2 * small_ops(n))
    return n["T"] * n["S"] * per


def rollout_bound_ms(kind: str, n: dict, dtype: str):
    """(ms, 'bytes' | 'operations') of one K6 entry call, ``kind`` 'fwd' or 'bwd'."""
    size = ELEM_BYTES[dtype]
    inputs = operand_elems(n)
    if kind == "fwd":
        outputs = n["S"] + (n["T"] + 1) * n["S"] * n["D"]
        return bound_ms((inputs + outputs) * size, fwd_ops(n), dtype)
    inputs += n["S"] + n["T"] * n["S"] * n["D"] - n["S"] * n["D"]  # gl; the trajectory replaces x0
    outputs = n["Lp"] * n["Mp"] * n["De"] + n["Lp"] * n["Mp"] + n["Lp"] * n["De"]
    return bound_ms((inputs + outputs) * size, bwd_ops(n), dtype)
