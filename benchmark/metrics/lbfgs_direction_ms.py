"""Mean milliseconds of the L-BFGS direction (the two-loop) per iteration,
from the program's ``pb.lbfgs_times`` of a timed run of the window's round
from the same parameters, after the traced one."""


def read(run):
    times = run.lbfgs_times
    if not times:
        return None
    return 1e3 * sum(t["direction"] for t in times) / len(times)
