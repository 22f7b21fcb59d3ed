"""100 - the device-busy time of the traced Adam round over the untraced
window that did the same work."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run) if run.unit == "epoch" else None
