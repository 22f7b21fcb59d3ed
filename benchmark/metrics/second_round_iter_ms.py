"""The window's milliseconds over the second-round iterations it completed
(host clock, ending in a synchronisation)."""


def read(run):
    if run.unit != "iter":
        return None
    return 1e3 * run.window_s / run.steps
