"""Device idle time under the program's ``objective`` spans and their
children (the loss, its backward, the sum over a mesh) over the traced
window of the Adam epochs, in percent."""

from benchmark import spans


def read(run):
    joined = spans.joined(run) if run.unit == "epoch" else None
    if joined is None or not joined.indices("objective"):
        return None
    return joined.idle_pct(lambda i: joined.under(i, "objective"))
