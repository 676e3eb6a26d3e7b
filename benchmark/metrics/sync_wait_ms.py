"""Mean host time a window step waits for the device in its host syncs
(every ``sync.*`` span, ``utils/tracing.py:host_sync``), in ms."""
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
    if not window:
        return None
    return 1e-6 * sum(s.ns for r in window for s in r.spans if s.name.startswith("sync.")) / len(window)
