"""K6's backward entry: its least time at the cell's shapes and dtype over
its mean device time per entry call in the profiled slice, in %."""
from benchmark.counts.rollout import rollout_bound_ms


def read(run):
    k6 = run["trace"].get("k6", {}).get("bwd") if run["trace"] else None
    if not k6 or k6["ms"] <= 0:
        return None
    return 100.0 * rollout_bound_ms("bwd", run["dims"], run["dtype"])[0] / k6["ms"]
