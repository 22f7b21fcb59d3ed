"""Seconds of the case builders, from the inputs to a ready problem (host
clock around the case builders' call, ending in a synchronisation)."""


def read(run):
    return run.build_s
