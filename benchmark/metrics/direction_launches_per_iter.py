"""Kernel launches (the host's launch calls in the trace) inside the L-BFGS
two-loop's ``lbfgs.direction`` spans over the traced window's ``step``
spans (its iterations).  Only a trace of the card has launch calls."""

from benchmark import spans


def read(run):
    joined = spans.joined(run) if run.unit == "iter" else None
    if joined is None or not run.traces[0].device or not joined.steps:
        return None
    launches = sum(joined.launches.get(i, 0)
                   for i in joined.indices("lbfgs.direction"))
    return launches / joined.steps
