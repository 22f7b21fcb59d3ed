"""The port's profiling hooks (tpinn_torch/profiling.py) against the JAX
package's: ``SectionTimer`` counts and totals its sections and reports them
in tpinn's format, in tpinn's order; ``trace`` writes a trace of a short
round that a trace viewer opens (a Chrome-trace JSON holding the round's
operations), where tpinn's ``jax.profiler.trace`` writes its own.

The program's spans (the port's own, no counterpart in tpinn): off without
a profiler, nested with their parent and step under one, on the
trace's clock, one per layer boundary of the L-BFGS and Adam rounds as
their counters count them, and without effect on the parameters."""

import contextlib
import json
import os
import re
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpinn import profiling as jprof
from tpinn_torch import profiling as tprof
from tpinn_torch.losses import LossMeanSquares
from tpinn_torch.models import Model
from tpinn_torch.optimize import minimize
from tpinn_torch.optimizers import Adam
from tpinn_torch.problem import OptimizationProblem

torch.set_num_threads(1)

SECTIONS = (("a", 0.02), ("b", 0.0), ("a", 0.01), ("c", 0.005))


def _time(timer):
    for name, seconds in SECTIONS:
        with timer.section(name):
            time.sleep(seconds)
    return timer


@pytest.mark.parametrize("sync", [True, False])
def test_section_timer_like_tpinn(sync):
    ref, got = _time(jprof.SectionTimer(sync=sync)), \
        _time(tprof.SectionTimer(sync=sync))
    assert got.counts == ref.counts == {"a": 2, "b": 1, "c": 1}
    assert got.totals["a"] >= 0.03 and got.totals["c"] >= 0.005
    pattern = re.compile(r"^(\w+): \d+\.\d{3}s over (\d+) calls$")
    for timer in (ref, got):
        rows = [pattern.match(l).groups() for l in timer.report().splitlines()]
        assert sorted(rows) == [("a", "2"), ("b", "1"), ("c", "1")]
        # the longest total first (on a loaded host an empty section may
        # outlast a short sleep, so the order is read from the totals)
        names = [name for name, _ in rows]
        assert names == sorted(timer.totals, key=lambda k: -timer.totals[k])


def test_section_timer_counts_a_raising_section():
    timer = tprof.SectionTimer()
    with pytest.raises(ValueError):
        with timer.section("x"):
            raise ValueError
    assert timer.counts == {"x": 1}


def test_trace_writes_a_viewable_trace(tmp_path, capsys):
    from tpinn_torch.models import Model

    model = Model([2, 8, 3], device="cpu")
    x = torch.rand(16, 2, dtype=model.dtype)
    with tprof.trace(str(tmp_path / "port"), create_perfetto_link=True):
        model(x).sum()
    files = os.listdir(tmp_path / "port")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert files[0] in capsys.readouterr().out
    with open(tmp_path / "port" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # tpinn's own trace of the same block writes its profile too
    import jax.numpy as jnp

    with jprof.trace(str(tmp_path / "jax")):
        jnp.tanh(jnp.ones(16)).block_until_ready()
    assert any(files for _, _, files in os.walk(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded():
    """An empty span list before the test and after it."""
    tprof.clear_spans()
    yield
    tprof.clear_spans()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _nest():
    with tprof.span("round"):
        for _ in range(2):
            with tprof.span("step"):
                with tprof.span("objective"):
                    with tprof.span("objective.forward"):
                        pass
                with tprof.span("host_read"):
                    pass
        with tprof.span("log_point"):
            pass


def test_spans_off_without_a_profiler_and_nested_under_one(recorded):
    _nest()
    assert tprof.spans() == []
    with _profiled():
        _nest()
    got = tprof.spans()
    assert [s.name for s in got] == [
        "round", "step", "objective", "objective.forward", "host_read",
        "step", "objective", "objective.forward", "host_read", "log_point"]
    names = [s.name for s in got]
    assert [None if s.parent is None else names[s.parent] for s in got] == [
        None, "round", "step", "objective", "step", "round", "step",
        "objective", "step", "round"]
    assert [s.step for s in got] == [None, 0, 0, 0, 0, 1, 1, 1, 1, None]
    for s in got:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    tprof.clear_spans()
    assert tprof.spans() == []


def test_a_span_holds_the_trace_events_of_its_operations(recorded):
    """The shared clock: every kineto event of the torch operations run
    inside a span (CPU activity) lies inside the span's interval."""
    x = torch.rand(64, 64, dtype=torch.float64)
    with _profiled() as prof:
        for i in range(20):
            with tprof.span(f"work{i}"):
                torch.tanh(x @ x).sum()
    got = {s.name: s for s in tprof.spans()}
    inside = 0
    for e in prof.profiler.kineto_results.events():
        if e.name() in got:
            # the span's own record_function range
            s = got[e.name()]
        elif e.name().startswith("aten::"):
            s = next((s for s in got.values()
                      if s.start_ns <= e.start_ns() <= s.end_ns), None)
            assert s is not None, e.name()
        else:
            continue
        assert s.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns
        inside += 1
    assert inside >= 20 * 3


def _problem(seed=0):
    """A 2-16-16-3 tanh net fitted to a fixed random field: a loss that
    thirty L-BFGS iterations do not drive to zero."""
    g = torch.Generator().manual_seed(seed)
    model = Model([2, 16, 16, 3], device="cpu", dtype=torch.float64,
                  generator=g)
    x = torch.rand((64, 2), generator=g, dtype=torch.float64)
    target = torch.rand((64, 3), generator=g, dtype=torch.float64)
    fit = LossMeanSquares("fit", lambda: model(x) - target)
    return model, OptimizationProblem(model, [fit], [])


def _children(got, parent):
    return [s for s in got if s.parent is not None and got[s.parent] is parent]


def test_lbfgs_round_spans_match_its_counts(recorded):
    model, pb = _problem()
    with _profiled():
        minimize(pb, "jax", "L-BFGS", num_epochs=30)
    got = tprof.spans()
    counts = pb.lbfgs_counts
    by = lambda name: [s for s in got if s.name == name]
    (rnd,) = by("round")
    steps = by("step")
    assert len(steps) == counts["iterations"] == 30
    assert [s.step for s in steps] == list(range(30))
    assert all(got[s.parent] is rnd for s in steps)
    assert len(by("linesearch.trial")) == counts["trials"]
    assert len(by("objective")) == counts["evaluations"]
    assert len(by("objective.forward")) == len(by("objective.backward")) \
        == counts["evaluations"]
    assert by("objective.allreduce") == []
    log_points = by("log_point")
    assert len(log_points) == len(pb.history.iters) == 4
    assert len(by("host_read")) == counts["trials"] + len(log_points)
    for s in steps:
        kids = [k.name for k in _children(got, s)]
        assert kids.count("lbfgs.direction") == kids.count("linesearch") == 1
    for s in by("linesearch.trial"):
        assert got[s.parent].name == "linesearch"
        assert [k.name for k in _children(got, s)] == ["objective",
                                                       "host_read"]
    for s in log_points:
        assert got[s.parent] is rnd
        assert [k.name for k in _children(got, s)] == ["host_read"]
    for s in got:
        if s.parent is not None and s.name != "step":
            assert s.step == got[s.parent].step


def test_adam_round_spans_one_step_and_update_per_epoch(recorded):
    model, pb = _problem()
    with _profiled():
        minimize(pb, "adam", Adam(1e-3), num_epochs=25)
    got = tprof.spans()
    steps = [s for s in got if s.name == "step"]
    assert len(steps) == 25 and [s.step for s in steps] == list(range(25))
    for s in steps:
        assert [k.name for k in _children(got, s)] == ["objective",
                                                       "adam.update"]
    assert sum(s.name == "adam.update" for s in got) == 25
    assert sum(s.name == "log_point" for s in got) == 4
    assert sum(s.name == "host_read" for s in got) == 4


@pytest.mark.parametrize("round_", [("jax", "L-BFGS"), ("jax", "BFGS"),
                                    ("adam", None)])
def test_parameters_bit_equal_with_spans_on_and_off(recorded, round_):
    strategy, method = round_
    after = []
    for on in (False, True):
        model, pb = _problem(seed=3)
        opt = Adam(1e-3) if method is None else method
        with _profiled() if on else contextlib.nullcontext():
            minimize(pb, strategy, opt, num_epochs=20)
        after.append([p.detach().clone() for p in model.flat_params()])
        assert bool(tprof.spans()) is on
    for a, b in zip(*after):
        assert torch.equal(a, b)
