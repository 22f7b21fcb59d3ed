"""Kernel 3's (the Poisson one-pass backward) share of its roofline in the
Adam epochs."""

from benchmark import readers


def read(run):
    if run.unit != "epoch":
        return None
    return readers.roofline_pct(run, run.bwd_kernel, "poisson")
