"""Runs of the harness on the CPU at a small size: the port's plain path
against the reference, whole runs that come out correct, the same runs
with the timed path broken underneath that come out not correct, and the
control (the reference in float32) that fails the committed limits.

On the CPU the fused objectives take their plain PyTorch twins, so these
tests drive everything a chip run drives except the kernels and the card's
clock."""

from __future__ import annotations

import argparse

import pytest
import torch

from benchmark import check, harness, run, spec
from benchmark.reference import mlp

SMALL = {"n_pde": 384, "ref_block": 128}
CELLS = ("poiseuille_flow.adam.n4m", "poisson.adam.n4m",
         "poiseuille_flow.lbfgs.n4m")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, seed=2 ** 32 + 17, trace=0, seconds=0.5):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return run.run(args, device=CPU, cfg_override=SMALL)


def _cfg(cell):
    bench = spec.load_benchmark()
    return dict(spec.config(bench, spec.cell(bench, cell)), **SMALL)


@pytest.mark.parametrize("cell", CELLS[:2])
def test_reference_agrees_with_the_ports_plain_path(cell):
    cfg = _cfg(cell)
    prog_mod, ref_mod = spec.problem_modules(cfg)
    inputs = ref_mod.make_inputs(cfg, 5)
    pb, model = prog_mod.build(cfg, inputs, CPU)
    loss_p, grads_p = pb.loss_and_grads(model.flat_params())
    loss_p = loss_p.detach()
    params = [{k: torch.as_tensor(p[k]).clone().requires_grad_(True)
               for k in ("kernel", "bias")} for p in inputs["params"]]
    loss_r, grads_r = ref_mod.Objective(cfg, inputs, CPU).value_and_grad(
        params)
    assert abs(float(loss_p) - float(loss_r)) <= 1e-12 * abs(float(loss_r))
    for gp, gr in zip(grads_p, grads_r):
        assert torch.allclose(gp, gr, rtol=1e-10, atol=1e-12 * float(
            max(g.abs().max() for g in grads_r)))


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    names = [m["name"] for m in spec.metrics(spec.load_benchmark(), cell,
                                             trace=False)]
    assert sorted(res["metrics"]) == sorted(names)
    assert res["attempted"] >= 10 and res["failed"] == 0


def test_a_traced_run_reads_the_spans():
    res = _run(CELLS[2], trace=1, seconds=2.0)
    assert res["correct"]
    for name in ("build_s", "lbfgs_direction_ms", "lbfgs_iter_ms_p95"):
        assert name in res["metrics"]
    # no device on the CPU: no device share is reported
    assert "device_idle_pct.iter" not in res["metrics"]


@torch.no_grad()
def _frozen_step(self, params, grads):
    """A step that leaves the parameters as they were (their version still
    moves, as an update's would)."""
    self.step_count += 1
    for p, u in zip(params, self.updates(params, grads)):
        p.add_(u, alpha=0.0)


def _half_batch(monkeypatch):
    from tpinn_torch.kernels import mlp_bundle

    ns, po = (mlp_bundle.ns_residual_weighted_obj,
              mlp_bundle.poisson_residual_weighted_obj)

    def ns_half(params, x, physics, norm, weights, n_valid=None, n_mean=None):
        h = x.shape[0] // 2
        return ns(params, x[:h], physics, norm, weights, n_mean=h)

    def po_half(params, x, f, weight, normalization=1.0, **kw):
        h = x.shape[0] // 2
        return po(params, x[:h], f[:h], weight, normalization=normalization)

    monkeypatch.setattr(mlp_bundle, "ns_residual_weighted_obj", ns_half)
    monkeypatch.setattr(mlp_bundle, "poisson_residual_weighted_obj", po_half)


def _unchanged_state(monkeypatch):
    from tpinn_torch import linesearch, optimizers

    monkeypatch.setattr(optimizers.Optimizer, "step", _frozen_step)
    update = linesearch.ScaleByZoomLinesearch.update

    def no_move(self, updates, state, params, **kw):
        upd, new = update(self, updates, state, params, **kw)
        return upd * 0.0, new

    monkeypatch.setattr(linesearch.ScaleByZoomLinesearch, "update", no_move)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    {"unchanged_state": _unchanged_state, "half_batch": _half_batch}[fault](
        monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]


def _ring_from_slot_0(monkeypatch):
    """The two-loop read from slot 0 on, whatever the ring's newest slot:
    the same product until the ring wraps, a wrong one after."""
    from tpinn_torch import optimize

    inner = optimize._precondition_by_lbfgs

    def from_slot_0(*args):
        return inner(*args[:-1], 0)

    monkeypatch.setattr(optimize, "_precondition_by_lbfgs", from_slot_0)


def test_a_wrong_ring_order_after_the_wrap_is_not_correct(monkeypatch):
    """Only the check of the warm-up's last iteration, past the ring's
    wrap, sees this fault; the first steps agree."""
    _ring_from_slot_0(monkeypatch)
    res = _run(CELLS[2])
    checks = res["checks"]
    assert not res["correct"], checks
    assert checks["dir_gap"]["value"] > checks["dir_gap"]["limit"], checks
    for name in ("loss_gap", "grad_gap", "change_gap", "late_grad_gap"):
        assert checks[name]["value"] <= checks[name]["limit"], checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    """The reference in float32 in the program's place fails the committed
    limits, and the program's own readings pass them."""
    from benchmark import control

    out = control.readings(cell, 11, CPU, cfg_override=SMALL)
    limits = spec.limits(spec.cell(spec.load_benchmark(), cell))
    assert check.verdict(out["program"], limits)[0], out
    assert not check.verdict(out["control_float32"], limits)[0], out


# the point mesh: no cell of BENCHMARK.json runs it yet (PERF.md, Open
# questions); its traffic and limits are in place for the cell that will
FOUR = {"name": "poiseuille_flow.adam.n16m.4chip",
        "config": "poiseuille_flow", "traffic": "adam.n16m.4chip",
        "chips": 4, "why": "the point mesh"}


def no_exchange():
    """Planted in every rank: the sum over the mesh left out, each rank
    keeping its own share."""
    from tpinn_torch import sharding

    sharding.all_reduce_sum = lambda mesh, *tensors: tuple(tensors)


@pytest.mark.parametrize("plant", [None, no_exchange])
def test_the_point_mesh_on_four_cpu_ranks(plant):
    """A's round on four gloo ranks: sound, it is correct; with the exchange
    between ranks left out, it is not."""
    bench = spec.load_benchmark()
    bench["workloads"].append(FOUR)
    args = argparse.Namespace(workload=FOUR["name"], seed=2 ** 33 + 3,
                              seconds=0.5, trace=0)
    res = run.run(args, device=CPU, cfg_override={"n_pde": 128,
                                                  "ref_block": 256},
                  plant=plant, bench=bench)
    assert res["device"]["count"] == 4
    assert res["correct"] is (plant is None), res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell, card):
    """On the card, at the cell's own size: the control and the planted
    faults each fail the committed limits (python -m benchmark.control
    prints the readings)."""
    from benchmark import control

    out = control.readings(cell, 2 ** 32 + 5, card)
    limits = spec.limits(spec.cell(spec.load_benchmark(), cell))
    assert check.verdict(out["program"], limits)[0], out
    for name in ("control_float32", "fault_half_batch"):
        assert not check.verdict(out[name], limits)[0], out
