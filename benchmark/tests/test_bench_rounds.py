"""Round kinds found by name (``benchmark/rounds/``): each cell's rounds give
what the program's ``minimize`` and the plain reference give when called
directly, a new kind is one new file, an unknown method fails at set-up,
and the harness's own files name no method."""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import time

import pytest
import torch

from benchmark import harness, run, spec
from benchmark.reference import optim

SMALL = {"n_pde": 384, "ref_block": 128}
CELLS = ("poiseuille_flow.adam.n4m", "poisson.adam.n4m",
         "poiseuille_flow.lbfgs.n4m")
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _direct_round(pb, step, n, lr):
    from tpinn_torch.optimize import minimize
    from tpinn_torch.optimizers import Adam

    if step["method"] == "Adam":
        minimize(pb, step["strategy"], Adam(lr), num_epochs=n)
    else:
        minimize(pb, step["strategy"], step["method"], num_epochs=n)


def _direct_setup(cfg, traffic, inputs, prog_mod):
    """The program's ``minimize`` called directly: the check steps recorded
    through the problem's own entry points, the set-up rounds, the warm-up,
    and the problem it leaves."""
    from tpinn_torch.optimize import minimize
    from tpinn_torch.optimizers import Adam

    lr = cfg["adam_lr"]
    pb, model = prog_mod.build(cfg, inputs, CPU)
    step = traffic["check"]
    losses, first = [], {}
    if step["method"] == "Adam":
        class FirstState(Adam):
            def step(self, params, grads):
                super().step(params, grads)
                if self.step_count == 1:
                    first["grad0"] = [m / (1.0 - self.b1) for m in self.mu]

        inner = pb.loss_and_grads

        def recording(tensors):
            loss, grads = inner(tensors)
            losses.append(loss.detach().clone())
            return loss, grads

        pb.loss_and_grads = recording
        minimize(pb, step["strategy"], FirstState(lr),
                 num_epochs=step["steps"])
        del pb.loss_and_grads
    else:
        inner = pb.flat_value_and_grad

        def recording(theta):
            value, grad = inner(theta)
            losses.append(value.detach().clone())
            first.setdefault("flat", grad.detach().clone())
            return value, grad

        pb.flat_value_and_grad = recording
        minimize(pb, step["strategy"], step["method"],
                 num_epochs=step["steps"])
        del pb.flat_value_and_grad
        first["grad0"] = [t for layer in pb.unravel(first["flat"])
                          for t in (layer["kernel"], layer["bias"])]
    record = {"losses": torch.stack(losses).tolist(),
              "grad0": first["grad0"],
              "final": [t.detach().clone() for t in model.flat_params()]}
    for s in traffic["setup_rounds"]:
        _direct_round(pb, s, s["steps"], lr)
    _direct_round(pb, traffic["round"], traffic["warmup_steps"], lr)
    return record, pb


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("cell", CELLS)
def test_round_kinds_give_what_direct_calls_give(cell):
    """Through the lookup, each cell's check record, the late state its
    warm-up leaves and the references' records are bit-equal to the
    program's ``minimize`` and ``reference/optim.py`` called directly."""
    bench = spec.load_benchmark()
    cell_ = spec.cell(bench, cell)
    state = harness.setup_and_window(bench, cell_, SEED, 0.0, False, CPU,
                                     time.perf_counter(), cfg_override=SMALL)
    cfg, traffic, inputs = state["cfg"], state["traffic"], state["inputs"]
    prog_mod, ref_mod = state["prog_mod"], state["ref_mod"]
    record, pb = _direct_setup(cfg, traffic, inputs, prog_mod)
    assert _same(state["prog_record"], record)

    step = traffic["check"]
    objective = ref_mod.Objective(cfg, inputs, CPU)
    direct_ref = (optim.adam(objective, inputs["params"], step["steps"],
                             cfg["adam_lr"]) if step["method"] == "Adam"
                  else optim.lbfgs(objective, inputs["params"],
                                   step["steps"]))
    assert _same(harness.reference(state, CPU), direct_ref)

    late = state["late"]
    if traffic["round"]["method"] == "Adam":
        assert late is None
        return
    lb = pb.last_opt_state["lbfgs"]
    f64 = lambda t: t.detach().to(torch.float64)
    assert late["count"] == traffic["warmup_steps"]
    assert _same(late["ring_dx"], f64(lb["diff_params_memory"]))
    assert _same(late["ring_dg"], f64(lb["diff_updates_memory"]))
    assert _same(late["x_prev"], f64(lb["params"]))
    assert _same(late["g_prev"], f64(lb["updates"]))
    assert late["eta"] == float(pb.last_opt_state["learning_rate"])
    assert _same(late["x_now"], f64(pb.get_flat()))
    late_ref = harness.late_reference(state, CPU)
    assert _same(late_ref["direction"], optim.ring_direction(
        late["g_prev"], late["ring_dx"], late["ring_dg"], late["count"]))
    leaves = late["x_prev_leaves"]
    params = [{"kernel": leaves[i].clone().requires_grad_(True),
               "bias": leaves[i + 1].clone().requires_grad_(True)}
              for i in range(0, len(leaves), 2)]
    _, grads = ref_mod.Objective(cfg, inputs, CPU).value_and_grad(params)
    assert _same(late_ref["grad_leaves"], [g.detach() for g in grads])


def _renamed(monkeypatch, old: str, new: str):
    """Every traffic step of method ``old`` given the method ``new``."""
    traffic = spec.traffic

    def renamed(cell_):
        t = traffic(cell_)
        for s in [t["check"], t["round"], *t["setup_rounds"]]:
            if s["method"] == old:
                s["method"] = new
        return t

    monkeypatch.setattr(spec, "traffic", renamed)


def _run(cell):
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=0.5,
                              trace=0)
    return run.run(args, device=CPU, cfg_override=SMALL)


def test_a_round_kind_is_one_new_file(tmp_path, monkeypatch):
    """A copy of ``adam.py`` under another name, alone in a rounds
    directory, runs a cell whose steps name it, with no other change."""
    rounds = tmp_path / "rounds"
    rounds.mkdir()
    shutil.copy(os.path.join(spec.ROUNDS, "adam.py"),
                rounds / "adam-copy.py")
    monkeypatch.setattr(spec, "ROUNDS", str(rounds))
    _renamed(monkeypatch, "Adam", "Adam-Copy")
    found = []
    round_kind = spec.round_kind
    monkeypatch.setattr(spec, "round_kind",
                        lambda m: found.append(m) or round_kind(m))
    res = _run(CELLS[1])
    assert res["correct"], res["checks"]
    assert found and set(found) == {"Adam-Copy"}


def test_an_unknown_method_fails_at_set_up(monkeypatch):
    """The error names the file looked for, before anything is built."""
    _renamed(monkeypatch, "L-BFGS", "Newton")

    def built(cfg):
        raise AssertionError("the problem was built")

    monkeypatch.setattr(spec, "problem_modules", built)
    with pytest.raises(LookupError, match=r"rounds/newton\.py"):
        _run(CELLS[2])


def test_every_method_has_its_file_and_the_harness_names_none():
    methods = set()
    for path in glob.glob(os.path.join(spec.HERE, "workloads", "*.json")):
        t = spec._json(path)
        methods |= {s["method"]
                    for s in [t["check"], t["round"], *t["setup_rounds"]]}
    for m in methods:
        kind = spec.round_kind(m)
        for name in ("run", "check_steps", "reference"):
            assert callable(getattr(kind, name)), (m, name)
    literal = re.compile(r"""(["'])(Adam|L-BFGS|BFGS|LM)\1""")
    for name in ("harness.py", "run.py", "control.py", "check.py"):
        with open(os.path.join(spec.HERE, name)) as f:
            assert not literal.search(f.read()), name
