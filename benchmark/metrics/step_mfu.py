"""The whole step's share of the card's peak: the operations a step needs
(path sampling and K6's forward and backward, counted from the shapes)
times the window's steps over its seconds, over the dtype's vector peak,
in %."""
from benchmark.counts.peaks import PEAK_FLOPS


def read(run):
    w = run["window"]
    if not w["steps"] or not w["seconds"] > 0:
        return None
    return 100.0 * run["step_ops"] * w["steps"] / w["seconds"] / PEAK_FLOPS[run["dtype"]]
