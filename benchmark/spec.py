"""What a run reads, found by name: BENCHMARK.json at the root of the
checkout, a cell's configuration (``configs/<config>.json``), its traffic
(``workloads/<traffic>.json``), its correctness limits
(``limits/<cell>.json``) and the reader of each per-layer metric
(``metrics/<metric>.py``).  A later cell, configuration or metric is a new
file and a new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[c['name'] for c in bench['workloads']]}")


def config(bench: dict, cell_: dict) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell_["config"]:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {cell_['config']!r} in BENCHMARK.json")


def traffic(cell_: dict) -> dict:
    return _json(os.path.join(HERE, "workloads", cell_["traffic"] + ".json"))


def limits(cell_: dict) -> dict:
    return _json(os.path.join(HERE, "limits", cell_["name"] + ".json"))


def metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer metrics
    (on): those without a ``workloads`` key, and those that list it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded by path (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def problem_modules(cfg: dict):
    """(the program's side, the plain reference) of a configuration's
    problem: ``problems/<problem>.py`` and ``reference/<problem>.py``."""
    import importlib

    name = cfg["problem"]
    return (importlib.import_module(f"benchmark.problems.{name}"),
            importlib.import_module(f"benchmark.reference.{name}"))
