"""Arithmetic that several metric readers share.  A reader takes the run
(``benchmark.run.Run``) and returns a number, or None where the run holds
nothing for it to read; it never returns 0 for a share of a peak."""

from __future__ import annotations

from typing import Optional

from benchmark import work


def roofline_pct(run, pattern: str, problem: str) -> Optional[float]:
    """The least time of the kernels whose names match ``pattern`` over
    their device time on rank 0, in percent: each launch over one rank's
    PDE points, bound by the published peak of operations or of bytes."""
    if not run.traces:
        return None
    launches = run.traces[0].kernels(pattern)
    if not launches:
        return None
    least = work.least_seconds(problem, run.cfg["layers"], run.cfg["n_pde"],
                               True, run.kind)
    if least is None:
        return None
    device_s = sum(b - a for _, a, b in launches) / 1e6
    return 100.0 * len(launches) * least[0] / device_s


def step_mfu_pct(run, evaluations: int) -> Optional[float]:
    """The backward work of ``evaluations`` passes over every PDE point of
    every rank, frozen per point, over the (untraced) window and the chips'
    peak."""
    peaks = work.peaks(run.kind)
    if peaks is None or not run.window_s:
        return None
    flops = (run.points * evaluations
             * work.flops_per_point(run.cfg["problem"], run.cfg["layers"],
                                    True))
    return 100.0 * flops / run.window_s / (peaks["fp64_flops"] * run.chips)


def idle_pct(run) -> Optional[float]:
    """100 - the device-busy time of the traced round (the mean of the
    ranks) over the untraced window that did the same work: the trace slows
    the host's launches, not the device's work."""
    if not run.traces or None in run.busy or not run.window_s:
        return None
    busy = sum(b for b, _ in run.busy) / len(run.busy)
    return 100.0 * (1.0 - busy / run.window_s)
