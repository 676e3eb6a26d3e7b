"""Mean host time of a window step's forward through the particle loss's
graphed region, less its host syncs' waits, in ms: the packing of K6's
operands and K6's forward, the work that ``ops/graphs.py`` captures. On a
replayed step that is the ``graph.fwd`` span (the input copies and the
forward graph's replay); on an eager step the ``rollout.operands`` span
(``models/pathwise.py:fused_rollout_operands``) and the ``k6.fwd`` span
(``ops/rollout_cuda.py:_fwd``: the check, the plan and the launch; on the
card only, the CPU's plain rollout opens none). The same work on either
route, so the number moves with what that work costs the host."""
import sys

STORE = "gpflowpilco_torch.utils.tracing"  # the span store the program loaded
SPANS = ("graph.fwd", "rollout.operands", "k6.fwd")  # replayed; eager


def _window(run):
    """The window's step records: the last window-steps records held that ran
    with no profiler active."""
    tracing = sys.modules.get(STORE)
    if tracing is None:  # a program without the span store
        return []
    n = run["window"]["steps"]
    held = [r for r in tracing.steps() if not r.profiled and not r.aborted]
    return held[-n:] if n else []


def _ms_less_syncs(record, name):
    """ms of the record's spans called ``name``, less the ``sync.*`` spans
    under them; None when it has no such span."""
    under, ns = set(), None
    for i, s in enumerate(record.spans):  # a parent opens before its children
        if s.name == name:
            under.add(i)
            ns = (ns or 0) + s.ns
        elif s.parent in under:
            under.add(i)
            if s.name.startswith("sync."):
                ns -= s.ns
    return None if ns is None else 1e-6 * ns


def read(run):
    window = _window(run)
    found = [v for r in window for v in (_ms_less_syncs(r, name) for name in SPANS) if v is not None]
    return sum(found) / len(window) if found else None
