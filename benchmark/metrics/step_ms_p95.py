"""95th percentile of the window's step intervals, in ms (host clock);
nothing below 20 steps."""
import statistics


def read(run):
    steps = run["window"]["intervals"]
    if len(steps) < 20:
        return None
    return 1e3 * statistics.quantiles(steps, n=20, method="inclusive")[18]
