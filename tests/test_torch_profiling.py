"""The port's profiling hooks (tpinn_torch/profiling.py) against the JAX
package's: ``SectionTimer`` counts and totals its sections and reports them
in tpinn's format, in tpinn's order; ``trace`` writes a trace of a short
round that a trace viewer opens (a Chrome-trace JSON holding the round's
operations), where tpinn's ``jax.profiler.trace`` writes its own."""

import json
import os
import re
import time

import pytest
import torch

from tpinn import profiling as jprof
from tpinn_torch import profiling as tprof

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
