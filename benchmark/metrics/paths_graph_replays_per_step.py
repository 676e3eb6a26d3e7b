"""Mean count of replays of the path conditioning's CUDA graph in a window
step (``gpflowpilco_torch/models/pathwise.py:paths_from_noise`` through
``ops/graphs.py:replayed``; the step records' ``paths_graph_replays``): 1
where every window step replays it, 0 where the conditioning runs eager."""
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
    counts = [getattr(r, "paths_graph_replays", None) for r in _window(run)]
    if not counts or None in counts:  # no records, or a program that does not count these replays
        return None
    return sum(counts) / len(counts)
