"""Mean count of host syncs in a window step (``utils/tracing.py:host_sync``:
the escalating Cholesky's check per attempt level, the guard's finiteness
check), per step."""
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


def read(run):
    window = _window(run)
    return sum(r.host_syncs for r in window) / len(window) if window else None
