"""The join of the program's spans with a traced window (``benchmark.spans``):
idle gaps charged to the innermost span by its self time, launches counted
by span, on a trace made by hand; and traced runs of every cell on the CPU
at a small size that report each span metric of the cell."""

from __future__ import annotations

import math

import pytest

from benchmark import spans, spec
from benchmark.tests.test_bench_run import (  # noqa: F401
    CELLS, _few_threads, _run)
from tpinn_torch.profiling import Span


class _Trace:
    """A traced window by hand, in µs: device operations and host events."""

    def __init__(self, device, host, t0, t1):
        self.device, self.host, self.t0, self.t1 = device, host, t0, t1


def _span(name, a, b, parent=None, step=None):
    return Span(name, int(a * 1e3), int(b * 1e3), parent, step)


def test_idle_gaps_go_to_the_innermost_span():
    # round [0, 100]: step [10, 90] holding direction [10, 30] and a search
    # [30, 80] whose trial [40, 70] holds an objective [40, 60] and a read
    # [60, 70]; a span before the window is left out
    records = [_span("early", -50, -10), _span("round", 0, 100),
               _span("step", 10, 90, 1, 0),
               _span("lbfgs.direction", 10, 30, 2, 0),
               _span("linesearch", 30, 80, 2, 0),
               _span("linesearch.trial", 40, 70, 4, 0),
               _span("objective", 40, 60, 5, 0),
               _span("host_read", 60, 70, 5, 0)]
    # the device runs [0, 5], [20, 25], [45, 65] and [95, 100]
    device = [("k", 0.0, 5.0), ("k", 20.0, 25.0), ("k", 45.0, 65.0),
              ("k", 95.0, 100.0)]
    host = [("cudaLaunchKernel", 12.0, 13.0), ("cudaLaunchKernel", 15.0, 16.0),
            ("cuLaunchKernel", 41.0, 42.0), ("cudaMemcpyAsync", 61.0, 69.0)]
    joined = spans.Joined(records, _Trace(device, host, 0.0, 100.0))
    assert joined.names == ["round", "step", "lbfgs.direction", "linesearch",
                            "linesearch.trial", "objective", "host_read"]
    assert joined.parents == [None, 0, 1, 1, 3, 4, 4]
    by_name = {k: round(v * 1e6, 9) for k, v in joined.idle_by_name().items()}
    # idle: [5, 20] round 5 + direction 10, [25, 45] direction 5 + search
    # 10 + trial 0 + objective 5, [65, 95] read 5 + search 10 + step 10 +
    # round 5
    assert by_name == {"round": 10.0, "step": 10.0, "lbfgs.direction": 15.0,
                       "linesearch": 20.0, "objective": 5.0,
                       "host_read": 5.0, "none": 0.0}
    assert joined.idle_total_us == 65.0
    assert dict(joined.launches) == {2: 2, 5: 1}
    assert joined.steps == 1
    assert joined.idle_pct(lambda i: joined.under(i, "linesearch")) == 30.0


def test_idle_outside_every_span_stays_uncharged():
    records = [_span("step", 20, 40, None, 0)]
    joined = spans.Joined(records, _Trace([("k", 0.0, 10.0)], [], 0.0, 50.0))
    assert joined.idle_by_name() == {"step": 20e-6, "none": 20e-6}


SPAN_METRICS = {
    CELLS[0]: ["objective_idle_pct.epoch"],
    CELLS[1]: ["objective_idle_pct.epoch"],
    CELLS[2]: ["direction_idle_pct.iter", "linesearch_idle_pct.iter",
               "host_reads_per_iter"],
}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_span_metrics(cell):
    res = _run(cell, trace=1, seconds=1.0)
    assert res["correct"], res["checks"]
    for name in SPAN_METRICS[cell]:
        assert math.isfinite(res["metrics"][name]["value"]), name
    # no launch call in a trace of the CPU
    assert "direction_launches_per_iter" not in res["metrics"]
    if cell == CELLS[2]:
        # a flag read per trial, one to three trials an iteration, and a
        # log point's read every ten iterations
        reads = res["metrics"]["host_reads_per_iter"]["value"]
        assert 1.1 <= reads <= 3.1, reads
    listed = {m["name"] for m in spec.metrics(spec.load_benchmark(), cell,
                                              trace=True)}
    assert set(SPAN_METRICS[cell]) <= listed
