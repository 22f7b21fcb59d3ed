"""95th percentile over the iterations of the timed round (the window's
length) of direction plus evaluation milliseconds, from ``pb.lbfgs_times``."""

import statistics


def read(run):
    times = run.lbfgs_times
    if not times or len(times) < 20:
        return None
    ms = [1e3 * (t["direction"] + t["evaluations"]) for t in times]
    return statistics.quantiles(ms, n=20)[-1]
