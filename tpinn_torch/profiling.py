"""Profiling: a ``torch.profiler`` trace of training rounds, the program's
spans on the trace's clock, and a wall-clock section timer.

    with tpinn_torch.profiling.trace("/tmp/trace"):
        ns.minimize(pb, "jax", "L-BFGS", 1000)
    # -> open the .pt.trace.json in ui.perfetto.dev or TensorBoard: each
    #    span is a range above the operations and kernels it launched
    tpinn_torch.profiling.spans()   # the same spans as records

**Spans.**  ``span(name)`` marks one layer boundary of the rounds.  A span
records only while a ``torch.profiler`` profile records in this thread
(``torch._C._autograd._profiler_enabled()``); there is no other switch.
Off, a span costs one check.  On, it appends one ``Span(name, start_ns,
end_ns, parent, step)`` to a bounded in-memory list, which ``spans()``
returns in the order the spans opened and ``clear_spans()`` empties, and
opens a ``record_function`` range (its C++ form) of the same name.
``parent`` is the index in that list of the enclosing span (None at the
top); ``step`` is the ordinal, counted from 0 since the last
``clear_spans()``, of the enclosing ``step`` span: one Adam epoch or one
L-BFGS iteration (None outside one).

The spans the rounds open (``optimize.py``, ``problem.py``,
``linesearch.py``, ``optimizers.py``, ``sharding.py``):

    round              one ``optimize.minimize`` call
      step             one first-order epoch, one L-BFGS iteration
        objective      ``OptimizationProblem.loss_and_grads``, with
                       objective.forward (the loss), objective.backward
                       (``autograd.grad``), objective.allreduce (the sum
                       over a point mesh, only under one)
        adam.update    ``Optimizer.step`` (every first-order optimizer)
        lbfgs.direction  the two-loop (``_scale_by_lbfgs``)
        linesearch     ``ScaleByZoomLinesearch.update``
          linesearch.trial  one trial (``ZoomLinesearch.step``): objective,
                       then its flag read
      log_point        ``optimize._log_point`` (``eval_all``, callbacks)
    host_read          a blocking device-to-host read, inside whichever
                       span reads: a trial's flags, ``eval_all``'s losses,
                       the dense BFGS search's flag, ``sharding.all_ranks``

so the count of ``host_read`` spans is the count of the host's
synchronisations with the card on those paths.

**One clock with the device trace.**  A span's ends are ``time.time_ns()``
(Unix-epoch ns), the clock of the kineto events of ``torch.profiler``
(``prof.profiler.kineto_results.events()``, ``start_ns()``) in PyTorch 2.x:
host operations, CUDA runtime calls (``cudaLaunchKernel``) and device
kernels alike, so a span's interval is compared directly with the trace's
events.  The start is read before the span's ``record_function`` range
opens and the end after it closes, so a span's interval holds the trace
events of the work inside it (tests/test_torch_profiling.py on the CPU,
tests/test_torch_cuda.py on the card).  On an H100 with PyTorch
2.11.0+cu128, under CUDA activity alone and with CPU activity too, every
``cudaLaunchKernel`` call of 100 spans fell inside its span (at least
12.6 µs after its start, 2.9 µs before its end), and the kernels ran
after the spans that launched them opened; so does every launch of ten
traced L-BFGS iterations (PERF.md §3).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
# a span's range in the trace: PyTorch's C++ form of ``record_function``
# (about 2 µs a range against 16 on the CPU), where the build has it
_range = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)

# spans beyond this many since the last clear_spans() are not recorded
MAX_SPANS = 1 << 20


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    step: Optional[int]


_lock = threading.Lock()
# [name, start_ns, end_ns, parent, step] per span, in the order they opened
_records: List[list] = []
_steps = [0]
_local = threading.local()


def _open_stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """``with span(name):`` records the block as one span while a
    ``torch.profiler`` profile records (module docstring)."""

    __slots__ = ("name", "_rec", "_range")

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def __enter__(self):
        if not _profiler_enabled():
            return self
        stack = _open_stack()
        parent = stack[-1] if stack else None
        with _lock:
            if len(_records) >= MAX_SPANS:
                return self
            if self.name == "step":
                step = _steps[0]
                _steps[0] += 1
            else:
                step = _records[parent][4] if parent is not None else None
            index = len(_records)
            rec = [self.name, time.time_ns(), None, parent, step]
            _records.append(rec)
        stack.append(index)
        self._rec = rec
        self._range = _range(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            self._range.__exit__(*exc)
            rec[2] = time.time_ns()
            _open_stack().pop()
        return False


def spans() -> List[Span]:
    """The spans recorded since the last ``clear_spans()``, in the order
    they opened (one still open has ``end_ns`` None)."""
    with _lock:
        return [Span(*rec) for rec in _records]


def clear_spans() -> None:
    """Forget the recorded spans and restart the step count (between
    rounds: a span open across it keeps no parent in the new list)."""
    with _lock:
        _records.clear()
        _steps[0] = 0


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """``torch.profiler`` over the block (host activity, and the card's
    where one exists), written at its end into ``log_dir`` as a
    ``*.pt.trace.json`` Chrome trace, which Perfetto (ui.perfetto.dev) and
    TensorBoard open: the counterpart of ``jax.profiler.trace``.  The
    program's spans record inside it.  With ``create_perfetto_link`` the
    file's path is printed.  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = set(os.listdir(log_dir))
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
    if create_perfetto_link:
        for name in sorted(set(os.listdir(log_dir)) - before):
            print(f"trace: {os.path.join(log_dir, name)} (open in "
                  "ui.perfetto.dev)")


class SectionTimer:
    """Accumulating named wall-clock sections.

    With ``sync`` each section ends by waiting for the card's queued work,
    so that device time is charged to the section that launched it.
    """

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.sync = sync

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_available() \
                    and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{name}: {total:.3f}s over {self.counts[name]} calls"
            for name, total in rows
        )
