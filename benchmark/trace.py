"""What a traced window leaves: the device's operations and the host's
CUDA runtime calls, read from ``torch.profiler``, and the sums the
per-layer readers take from them.

The traced window runs from the start of its first device operation to
the end of its last.  Device-busy time is the union of the device
operations' intervals (``union_us``).  An idle gap is an interval of the
window in which no device operation ran; it is named by the innermost
host event at its middle (on the card a CUDA runtime call such as
``cudaLaunchKernel`` or ``cudaStreamSynchronize``), or "host python" where
none was: the host was running Python and PyTorch's dispatch.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _annotation(e) -> bool:
    """Whether a kineto event is an annotation, not an operation: by its
    activity type where the PyTorch build reports one, else by its flag,
    else by the one annotation the program's path lays over the device's
    kernels (c10d's "nccl:<collective>")."""
    kind = getattr(e, "activity_type", None)
    if callable(kind):
        return "annotation" in str(kind())
    flag = getattr(e, "is_user_annotation", None)
    return ((callable(flag) and bool(flag()))
            or e.name().startswith("nccl:"))


def _events(prof):
    """[(is_device, name, start_us, end_us)] of a finished profiler.  The
    device's annotations (a span such as "nccl:all_reduce" laid over the
    kernel that runs it) are left out: only operations the device ran."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None and hasattr(results, "events"):
        return [(e.device_type() == cuda, e.name(), e.start_ns() / 1e3,
                 (e.start_ns() + e.duration_ns()) / 1e3)
                for e in results.events()
                if not (e.device_type() == cuda and _annotation(e))]
    return [(e.device_type == cuda, e.name, e.time_range.start,
             e.time_range.end) for e in prof.events()
            if not (e.device_type == cuda and e.name.startswith("nccl:"))]


class Trace:
    """The operations of one traced window on one device."""

    def __init__(self, prof):
        events = _events(prof)
        dev = [(n, a, b) for is_dev, n, a, b in events if is_dev]
        self.t0 = min((a for _, a, _ in dev), default=0.0)
        self.t1 = max((b for _, _, b in dev), default=0.0)
        if not dev:
            # no device (a CPU run): the span of the host's operations
            host = [(a, b) for is_dev, _, a, b in events if not is_dev]
            self.t0 = min((a for a, _ in host), default=0.0)
            self.t1 = max((b for _, b in host), default=0.0)
        self.device = dev
        self.host = sorted(((n, a, b) for is_dev, n, a, b in events
                            if not is_dev and b > self.t0 and a < self.t1),
                           key=lambda e: e[1])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.device]) / 1e6

    def kernels(self, pattern: Optional[str] = None) -> List[tuple]:
        """Device kernels (copies and fills left out) whose name matches
        ``pattern`` (a regular expression), or all."""
        out = [e for e in self.device
               if not e[0].startswith(("Memcpy", "Memset"))]
        if pattern is not None:
            rx = re.compile(pattern)
            out = [e for e in out if rx.search(e[0])]
        return out

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time: [[name, seconds]]."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            by_name[name] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The window's idle time by what the host was doing:
        [[host operation, seconds]], the largest first."""
        gaps, end = [], self.t0
        for _, a, b in sorted((e for e in self.device), key=lambda e: e[1]):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        starts = [e[1] for e in self.host]
        by_name: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2.0
            i = bisect.bisect_right(starts, mid)
            best = None
            # the innermost host operation that covers the gap's middle
            for name, ha, hb in self.host[max(0, i - 64):i]:
                if ha <= mid <= hb and (best is None
                                        or hb - ha < best[2] - best[1]):
                    best = (name, ha, hb)
            by_name["host python" if best is None else best[0]] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:top]]
