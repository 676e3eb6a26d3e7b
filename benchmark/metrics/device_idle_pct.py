"""Share of the profiled slice's wall time in which no kernel, copy or fill
ran on the device, in %."""


def read(run):
    t = run["trace"]
    if not t or t["slice_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["slice_s"])
