"""The numbers that decide ``correct``, from the measured step's record and
the reference's.

- ``loss_gap``: the largest relative gap of the checked steps' losses;
  ``loss_gap_first``: the first step's alone, where the later steps' losses
  swing from seed to seed (Adam moves each leaf element whose gradient is
  near rounding by a whole learning rate, so the later steps start from
  parameters that differ in those elements).
- ``grad_gap``: the first step's gradient as the optimizer got it (clipped;
  worked out from Adam's first moment after one step), by the worst leaf:
  the gap between the two norms over the reference's norm of that leaf or
  of the median leaf, whichever is larger.
- ``change_gap``: the leaves' change after the checked steps, by the same
  measure, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf below that moves under Adam by
  round-off alone); ``change_gap_first``: the change after the first step
  alone, where the later steps swing as the losses do.
- ``cost_gap_median``: the first step's per-particle costs, the median
  over the particles of each particle's gap, over the median particle's
  cost; a few particles whose rollout is chaotic (near an unstable top)
  leave it steady.
- ``grad_gap_kept``: the first step's raw gradient (before the clip) of the
  mean cost over the kept particles, those whose reference rollout stays
  within a relative gap of its one-ulp twin at every step
  (``reference/pathwise.py:kept_particles``), by the worst leaf as
  ``grad_gap``. Under chaos it checks the backward where ``grad_gap`` can
  only read the rounding that chaos amplifies: ``cost_gap_median`` is forward
  only, and Adam's first step moves each element by about the learning rate
  whatever the gradient, so ``change_gap_first`` cannot see a wrong backward.
  It reads ``inf`` when fewer than ``KEPT_FLOOR`` (0.5) of the particles
  are kept, so that it cannot pass by leaving particles out; the kept share
  is reported beside it (``kept_share``).

A cell compares the numbers its limits file names, each against its limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

NUMBERS = ("loss_gap", "loss_gap_first", "grad_gap", "change_gap", "change_gap_first",
           "cost_gap_median", "grad_gap_kept")
KEEP_BELOW_MEDIAN = 1e-3
KEPT_FLOOR = 0.5  # the least share of kept particles grad_gap_kept reads at


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in leaves.items()}


def _worst(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    if not names:
        return float("nan")
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0 else float("inf")
               for k in names)


def _cost_gap(prog, ref) -> float:
    if prog is None or prog.shape != ref.shape:
        return float("inf")
    return float((prog.to(ref) - ref).abs().median() / ref.abs().median())


def compare(program: dict, reference: dict, diagnostics: bool = False) -> Dict[str, float]:
    """{number: value}; ``program`` and ``reference`` hold ``losses`` (list),
    ``costs`` (the first step's per particle; None where the route returned
    none), ``grad``, ``change_first`` and ``change`` (name -> tensor), and
    where the kept particles were drawn, ``grad_kept`` (name -> tensor; the
    reference also ``kept_share``), which adds ``grad_gap_kept`` and
    ``kept_share``."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        losses.append(float("inf"))
    g_prog, g_ref = _norms(program["grad"]), _norms(reference["grad"])
    c_prog, c_ref = _norms(program["change"]), _norms(reference["change"])
    f_prog, f_ref = _norms(program["change_first"]), _norms(reference["change_first"])
    names = list(g_ref)
    med = statistics.median(g_ref.values())
    kept = [k for k in names if g_ref[k] >= KEEP_BELOW_MEDIAN * med]
    out = dict(loss_gap=max(losses), loss_gap_first=losses[0], grad_gap=_worst(g_prog, g_ref, names),
               change_gap=_worst(c_prog, c_ref, kept), change_gap_first=_worst(f_prog, f_ref, kept),
               cost_gap_median=_cost_gap(program.get("costs"), reference["costs"]))
    if "grad_kept" in reference:
        share = reference["kept_share"]
        k_prog, k_ref = _norms(program["grad_kept"]), _norms(reference["grad_kept"])
        out.update(kept_share=share, grad_gap_kept=float("inf") if share < KEPT_FLOOR else _worst(
            k_prog, k_ref, names))
        if diagnostics:
            out.update({f"grad_kept_{k}": abs(k_prog[k] - k_ref[k]) / k_ref[k] for k in names})
    if diagnostics:
        med = sorted(kept, key=lambda k: c_ref[k])[len(kept) // 2]
        out.update(change_gap_median=_worst(c_prog, c_ref, [med]),
                   **{f"grad_{k}": abs(g_prog[k] - g_ref[k]) / g_ref[k] for k in names},
                   **{f"change_{k}": abs(c_prog[k] - c_ref[k]) / c_ref[k] for k in names})
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit, and the kept share beside its floor."""
    out = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    if "kept_share" in numbers:
        out["kept_share"] = dict(value=numbers["kept_share"], floor=KEPT_FLOOR)
    return out


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    out = []
    for k, c in checks(numbers, limits).items():
        bound = "floor" if "floor" in c else "limit"
        out.append(f"{k} {c['value']!r} {bound} {c[bound]!r}")
    return out
