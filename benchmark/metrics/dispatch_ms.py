"""Mean host time of a window step's ``opt.iter`` span (one Adam iteration of
``utils/optimizers.py``) less its host syncs' waits, in ms: the Python that
dispatches the step's work to the device."""
import sys

STORE = "gpflowpilco_torch.utils.tracing"  # the span store the program loaded


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
    found = [v for v in (_ms_less_syncs(r, "opt.iter") for r in window) if v is not None]
    return sum(found) / len(window) if found else None
