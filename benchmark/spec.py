"""What a run reads, found by name: BENCHMARK.json at the root of the
checkout, a cell's configuration (``configs/<config>.json``), its traffic
(``workloads/<traffic>.json``), its correctness limits
(``limits/<cell>.json``), the reader of each per-layer metric
(``metrics/<metric>.py``) and the kind of each round its traffic runs
(``rounds/<method>.py``).  A later cell, configuration, metric or round
kind is a new file and a new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ROUNDS = os.path.join(HERE, "rounds")


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


def _load(path: str, name: str) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def reader(metric_name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded by path (a name may hold dots)."""
    return _load(os.path.join(HERE, "metrics", metric_name + ".py"),
                 "benchmark.metrics." + metric_name.replace(".", "_"))


def round_kind(method: str) -> ModuleType:
    """``rounds/<method, lower-cased>.py``, loaded by path (a method may
    hold a dash); what it provides is in ``rounds/__init__.py``."""
    name = method.lower()
    path = os.path.join(ROUNDS, name + ".py")
    if not os.path.isfile(path):
        raise LookupError(f"no round kind for the method {method!r}: "
                          f"{path} does not exist")
    return _load(path, "benchmark.rounds."
                 + name.replace("-", "_").replace(".", "_"))


def problem_modules(cfg: dict):
    """(the program's side, the plain reference) of a configuration's
    problem: ``problems/<problem>.py`` and ``reference/<problem>.py``."""
    import importlib

    name = cfg["problem"]
    return (importlib.import_module(f"benchmark.problems.{name}"),
            importlib.import_module(f"benchmark.reference.{name}"))
