"""Mean host time from the loss closure's return to the next step's start,
in ms: the backward, the guard's wait for the device, the clip and Adam."""
import statistics


def read(run):
    gaps = run["window"]["after_return"]
    return 1e3 * statistics.fmean(gaps) if gaps else None
