"""Kernel 1's share of its roofline over the L-BFGS trials."""

from benchmark import readers


def read(run):
    if run.unit != "iter":
        return None
    return readers.roofline_pct(run, run.bwd_kernel, "ns")
