"""The whole L-BFGS iteration's share of the chip's float64 peak: PDE points
times the round's evaluations (``pb.lbfgs_counts``) times the frozen
backward operations per point, over the untraced window."""

from benchmark import readers


def read(run):
    if run.unit != "iter" or not run.counts:
        return None
    return readers.step_mfu_pct(run, run.counts["evaluations"])
