"""PDE points of every rank times the first-order epochs of the window, over
the window's seconds (host clock, ending in a synchronisation)."""


def read(run):
    if run.unit != "epoch":
        return None
    return run.points * run.steps / run.window_s
