"""Device idle time under the self time of the L-BFGS two-loop (the
program's ``lbfgs.direction`` span) over the traced window, in percent."""

from benchmark import spans


def read(run):
    joined = spans.joined(run) if run.unit == "iter" else None
    if joined is None or not joined.indices("lbfgs.direction"):
        return None
    return joined.idle_pct(lambda i: joined.names[i] == "lbfgs.direction")
