"""Kernel 1's (the NS one-pass backward) share of its roofline in the Adam
epochs."""

from benchmark import readers


def read(run):
    if run.unit != "epoch":
        return None
    return readers.roofline_pct(run, run.bwd_kernel, "ns")
