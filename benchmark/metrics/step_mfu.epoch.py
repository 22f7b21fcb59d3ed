"""The whole Adam step's share of the chips' float64 peak: PDE points times
epochs times the frozen backward operations per point, over the untraced
window."""

from benchmark import readers


def read(run):
    if run.unit != "epoch":
        return None
    return readers.step_mfu_pct(run, run.steps)
