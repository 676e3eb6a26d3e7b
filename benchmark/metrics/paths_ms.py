"""Mean host time a window step spends inside ``generate_paths_svgp``, in ms."""
import statistics


def read(run):
    spans = run["spans"]["paths"]
    return 1e3 * statistics.fmean(spans) if spans else None
