"""Mean host time a window step spends inside ``fused_rollout_costs`` (the
operands' packing and K6's forward entry), in ms."""
import statistics


def read(run):
    spans = run["spans"]["rollout_fwd"]
    return 1e3 * statistics.fmean(spans) if spans else None
