"""The program's spans of a traced window, joined with its device trace.

The program records its spans (``tpinn_torch.profiling.spans()``: name,
start and end in ns, parent, step) while a ``torch.profiler`` profile
records, on the clock of the trace's events, so the traced round leaves
them in rank 0's process, where the readers run.  Here they are kept where
they overlap the traced window ``[run.traces[0].t0, t1]`` and cut to it.

A span's self time is its interval less the parts its children cover; at
each instant of the window the innermost open span owns it.  An idle gap
of the trace (an interval in which no device operation ran) is split over
the spans whose self time covers it; the part under no span stays
uncharged.  A kernel launch (a ``cudaLaunchKernel``, ``cudaLaunchKernelExC``
or ``cuLaunchKernel`` host event) counts for the span whose self time holds
its start.

On the CPU the trace holds no device operation, so the whole window counts
as idle: the shares then read the spans' part of the host's time, a check
of the join and not a device reading.  A program that records no spans
(one that predates them) gives None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def _gaps(trace) -> List[tuple]:
    """[(start, end)] µs of the window's intervals with no device
    operation, in order."""
    gaps, end = [], trace.t0
    for _, a, b in sorted(trace.device, key=lambda e: e[1]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if trace.t1 > end:
        gaps.append((end, trace.t1))
    return gaps


def _segments(spans: List[tuple]) -> List[tuple]:
    """[(start, end, index)] of the instants each span owns (its self
    time), in order, from nested intervals [(start, end)] sorted by
    start."""
    out, stack, t = [], [], None

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][1] <= limit:
            _, end, i = stack.pop()
            if end > t:
                out.append((t, end, i))
            t = max(t, end)

    for i, (a, b) in enumerate(spans):
        if t is None:
            t = a
        close_until(a)
        if stack and a > t:
            out.append((t, a, stack[-1][2]))
        t = max(t, a)
        stack.append((a, b, i))
    close_until(float("inf"))
    return out


class Joined:
    """The spans of rank 0's traced window with the idle time and the
    launches charged to each (by index into ``spans``)."""

    def __init__(self, records, trace):
        t0, t1 = trace.t0, trace.t1
        self.window_us = t1 - t0
        kept = []
        for r in records:
            a = r.start_ns / 1e3
            b = t1 if r.end_ns is None else r.end_ns / 1e3
            if b > t0 and a < t1:
                kept.append((r, max(a, t0), min(b, t1)))
        kept.sort(key=lambda k: k[1])
        where = {id(r): i for i, (r, _, _) in enumerate(kept)}
        self.names = [r.name for r, _, _ in kept]
        # parent within the kept spans (None where it lies outside them)
        self.parents = [None if r.parent is None
                        else where.get(id(records[r.parent]))
                        for r, _, _ in kept]
        segments = _segments([(a, b) for _, a, b in kept])
        self.idle_us: Dict[int, float] = defaultdict(float)
        self.idle_total_us = 0.0
        j = 0
        for a, b in _gaps(trace):
            self.idle_total_us += b - a
            while j < len(segments) and segments[j][1] <= a:
                j += 1
            k = j
            while k < len(segments) and segments[k][0] < b:
                sa, sb, i = segments[k]
                self.idle_us[i] += min(b, sb) - max(a, sa)
                k += 1
        seg_starts = [s[0] for s in segments]
        self.launches: Dict[int, int] = defaultdict(int)
        for name, a, _ in trace.host:
            if name not in LAUNCH_CALLS:
                continue
            k = bisect.bisect_right(seg_starts, a) - 1
            if k >= 0 and a < segments[k][1]:
                self.launches[segments[k][2]] += 1

    def indices(self, name: str) -> List[int]:
        return [i for i, n in enumerate(self.names) if n == name]

    def under(self, i: int, name: str) -> bool:
        """Whether span ``i`` is ``name`` or lies inside one."""
        while i is not None:
            if self.names[i] == name:
                return True
            i = self.parents[i]
        return False

    def idle_pct(self, keep: Callable[[int], bool]) -> float:
        """The idle time charged to the spans ``keep`` accepts, in percent
        of the traced window."""
        idle = sum(us for i, us in self.idle_us.items() if keep(i))
        return 100.0 * idle / self.window_us

    def idle_by_name(self) -> Dict[str, float]:
        """Seconds of idle time charged to each span name, and to no span
        ("none")."""
        out: Dict[str, float] = defaultdict(float)
        for i, us in self.idle_us.items():
            out[self.names[i]] += us / 1e6
        out["none"] = (self.idle_total_us - sum(self.idle_us.values())) / 1e6
        return dict(out)

    @property
    def steps(self) -> int:
        return len(self.indices("step"))


def joined(run) -> Optional[Joined]:
    """The join of rank 0's traced window, or None where the run was not
    traced or the program recorded no span in it."""
    if not run.traces:
        return None
    cached = getattr(run, "_joined_spans", None)
    if cached is not None:
        return cached
    try:
        from tpinn_torch import profiling

        records = profiling.spans()
    except (ImportError, AttributeError):
        return None
    out = Joined(records, run.traces[0])
    if not out.names or not out.window_us:
        return None
    run._joined_spans = out
    return out
