"""The benchmark's files: found by name, within the contract's limits, the
frozen work counts, inputs from a seed, and no JAX anywhere on its path."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from benchmark import spec, work
from benchmark.reference import poiseuille, poisson

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [c["name"] for c in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["workloads"]:
        assert NAME.match(c["traffic"]) and c["chips"] in (1, 4)
        assert 1 <= len(c["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_cells_find_their_files_by_name():
    for c in BENCH["workloads"]:
        cfg = spec.config(BENCH, c)
        assert cfg["name"] == c["config"]
        traffic = spec.traffic(c)
        assert traffic["name"] == c["traffic"]
        late = ({"dir_gap", "late_grad_gap"}
                if traffic["round"]["method"] == "L-BFGS" else set())
        assert set(spec.limits(c)) == {"loss_gap", "grad_gap",
                                       "change_gap"} | late
        prog, ref = spec.problem_modules(cfg)
        assert hasattr(prog, "build") and hasattr(ref, "make_inputs")
        e2e = spec.metrics(BENCH, c["name"], trace=False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert spec.metrics(BENCH, c["name"], trace=True)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
        for w in m.get("workloads", []):
            spec.cell(BENCH, w)


def test_config_files_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) <= set(cfg["published"])


def test_frozen_work_counts():
    assert work.flops_per_point("poiseuille", [2, 32, 32, 32, 3], True) == 69830
    assert work.flops_per_point("poiseuille", [2, 32, 32, 32, 3], False) == 23205
    assert work.flops_per_point("poisson", [2, 20, 20, 20, 1], True) == 27648
    assert work.flops_per_point("poisson", [2, 20, 20, 20, 1], False) == 9165
    t, by = work.least_seconds("ns", [2, 32, 32, 32, 3], 4194304, True,
                               "NVIDIA H100 80GB HBM3")
    assert by == "operations" and abs(t - 4.3707e-3) < 1e-6
    assert work.least_seconds("ns", [2, 32, 32, 32, 3], 10, True, "cpu") is None


@pytest.mark.parametrize("module", [poiseuille, poisson])
def test_inputs_from_a_seed(module):
    cfg = dict(json.load(open(os.path.join(
        spec.HERE, "configs",
        "poiseuille_flow.json" if module is poiseuille else "poisson.json"))),
        n_pde=300)
    seed = 2 ** 31 + 987654321
    a, b = module.make_inputs(cfg, seed), module.make_inputs(cfg, seed)
    c = module.make_inputs(cfg, seed + 1)
    flat = lambda d: np.concatenate([np.asarray(v, dtype=float).ravel()
                                     for v in _leaves(d)])
    assert np.array_equal(flat(a), flat(b))
    assert not np.array_equal(flat(a), flat(c))
    assert a["n_pde_total"] == 300
    assert module.make_inputs(cfg, seed, ranks=4)["n_pde_total"] == 1200


def _leaves(d):
    if isinstance(d, dict):
        for k in sorted(d, key=str):
            yield from _leaves(d[k])
    elif isinstance(d, (list, tuple)):
        for v in d:
            yield from _leaves(v)
    else:
        yield d


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_in_the_sources():
    """Top-level names compared whole: ``tpinn_torch`` is not ``tpinn``."""
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {"jax", "jaxlib", "flax", "tpinn"}, path
            if os.sep + "reference" + os.sep in path:
                assert "tpinn_torch" not in tops, path


_PROBE = """
import sys, json, torch
sys.path.insert(0, {root!r})
from benchmark import run, harness, spec, readers, trace, check, work
bench = spec.load_benchmark()
for c in bench["workloads"]:
    cfg = spec.config(bench, c)
    prog, ref = spec.problem_modules(cfg)
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
import tpinn_torch.optimize, tpinn_torch.driver, tpinn_torch.sharding
import tpinn_torch.cases.poiseuille_flow, tpinn_torch.cases.poisson
import tpinn_torch.kernels.build
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF_PROBE = """
import sys, json
sys.path.insert(0, {root!r})
import benchmark.reference.mlp, benchmark.reference.optim
import benchmark.reference.poiseuille, benchmark.reference.poisson
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules_after(code):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code.format(root=spec.ROOT)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_after_a_dry_import():
    found = _modules_after(_PROBE)
    assert "tpinn_torch" in found
    assert not found & {"jax", "jaxlib", "flax", "tpinn"}


def test_reference_imports_nothing_of_the_port():
    found = _modules_after(_REF_PROBE)
    assert not found & {"tpinn_torch", "tpinn", "jax", "jaxlib", "flax"}
