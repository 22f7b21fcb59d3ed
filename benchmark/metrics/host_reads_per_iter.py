"""The program's ``host_read`` spans (each a blocking device-to-host read)
over its ``step`` spans (the L-BFGS iterations) in the traced window."""

from benchmark import spans


def read(run):
    joined = spans.joined(run) if run.unit == "iter" else None
    if joined is None or not joined.steps:
        return None
    return len(joined.indices("host_read")) / joined.steps
