"""100 - the device-busy time of the traced L-BFGS round over the untraced
window that did the same work."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run) if run.unit == "iter" else None
