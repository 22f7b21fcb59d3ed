"""The port's StandardNSDriver on a point mesh of gloo ranks spawned on the
CPU, against the JAX package's sharded and unsharded drivers: the port's
counterpart of tests/test_driver_sharded.py, on its case (``_spec()``:
Poiseuille on a 20 × 10 grid) with two option sets, n_pde 64 (16 per edge,
8 fit, 32 test) and n_pde 70 (10 per edge, 5 fit, 30 test: no batch
divides 3 or 8 ranks, and at 8 ranks three fit shards are padding alone).
The port's drivers take tpinn's grid, splits, boundary data, fit targets
and initial θ through ``from_arrays``, every rank the full arrays.

* the evaluation at θ0 at 3 and 8 ranks against tpinn's unsharded driver
  and its sharded one on as many devices: the global loss and every raw
  loss within 1e-10 relative (tpinn's bar, tests/test_driver_sharded.py);
* at 3 ranks (n_pde 70), Adam 20 then dense BFGS 10 (the main path's plain
  variant on the fused objective, and the paired variant with
  ``TPINN_USE_PALLAS=0``), Adam 20 + L-BFGS 10, Adam 20 + LM 5 on the fast
  Gram (``lm_used_fast_gram`` on every rank), Adam 20 + the host scipy
  BFGS 5, each against tpinn's unsharded history: Adam 1e-10, the second
  rounds 1e-8 (PERF.md section 2); θ byte-identical on every rank after
  every round;
* a PRESS_0 gauge case at 3 ranks (the raw PDE batch whole on every rank,
  counted once): θ0 and Adam 20 against tpinn's at 1e-10;
* ``save_results``: one run folder, written by rank 0 alone (its
  callbacks are rank 0's), with tpinn's file set and a History_Loss.json
  equal to the rounds' history;
* resume on the mesh: BFGS 5 saved, then 5 more from the folder, equal to
  BFGS 10 straight bit for bit;
* the port's own cases beyond tpinn's ``_spec()``, against the same run in
  one process: the unsteady path (the t = 0 losses sharded too) with the
  Neumann outflow, Adam 10 + dense BFGS 5, and the steady case with its
  Neumann outflow through LM 2 (the traction's point residuals with their
  mask-scale rows), at the same bars.

* the dry run's paths 2-4 (``tpinn_torch.entry.dryrun_jobs``) at 3 and 8
  ranks against __graft_entry__.py's: path 2 (one Adam step of the sharded
  fused objective on a batch of 64·n − 5 rows, the one-pass objective) on
  the JAX package's flagship θ0, its masked sharded loss against the JAX
  package's unsharded kernel on the true rows at the step's bars (float32
  1e-6, float64 1e-10); paths 3 (Adam 15 + L-BFGS 15, n_pde 64) and 4
  (Adam 10 + LM 4 on the fast Gram, n_pde 70) from the JAX driver's draws
  on the dry run's case, its hidden layers 8 wide, against its unsharded
  histories, Adam 1e-10, the second rounds 1e-8.

The ranks run ``tpinn_torch.sharded_runs.run_jobs`` (no JAX); tpinn runs in
this process.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tpinn as jns
from tests import test_torch_lm as lm
from tests.test_driver_sharded import _spec
from tests.test_torch_artifacts import ARTIFACTS
from tpinn import sharding as jsh
from tpinn.config import SimulationOptions as JaxOptions
from tpinn.driver import StandardNSDriver as JaxDriver
from tpinn.pallas.mlp_bundle import ns_residual_mse as jax_ns_mse
from tpinn_torch import entry, sharded_runs, sharding
from tpinn_torch.history import History
from tpinn_torch.pipeline import NSPhysics

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as graft  # noqa: E402

torch.set_num_threads(1)

EVAL_BAR = ADAM_BAR = 1e-10
ROUND_BAR = 1e-8
ADAM, BFGS, LBFGS, LM, SCIPY, RESUME = 20, 10, 10, 5, 5, 5
OPTS = {"64": dict(epochs=0, n_pde=64, n_bc=16, n_vel=8, n_pres=0,
                   n_test=32),
        "70": dict(epochs=0, n_pde=70, n_bc=10, n_vel=5, n_pres=0,
                   n_test=30)}
CASE = "tpinn_torch.cases.poiseuille_flow"
# the port's case with tpinn's _spec(): its grid, and no Neumann edge
# (the boundary values come with the arrays)
SPEC = {"grid_shape": (20, 10), "neumann": {}}
TIMEOUT, DEADLINE = 60.0, 300.0
# the dry run's paths 3-4 on a 2-8-8-8-3 net here (195 parameters: each
# rank's LM factors the whole damped system); tests/test_torch_entry.py
# runs them at the dry run's own widths
DRYRUN_WIDTH = 8


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _jax_driver(opts, mesh=None, spec=None, **kw):
    kw.setdefault("second_round", "none")
    return JaxDriver(spec or _spec(), JaxOptions(**OPTS[opts]),
                     save_results=False, seed=0, mesh=mesh, **kw)


def _jax_eval(jd):
    pb = jns.OptimizationProblem(jd.model.variables, jd.losses,
                                 jd.losses_test)
    total, train, test = jax.device_get(pb.eval_jit()(jd.model.params))
    return float(total), {**{k: float(v) for k, v in train.items()},
                          **{k: float(v) for k, v in test.items()}}


def _wrapped_plain(jd):
    """tpinn's problem with the PDE losses as scalar losses: the plain
    BFGS variant, which the port's fused objective takes."""
    losses = [jns.Loss(l.name, l.raw_value, weight=l.weight)
              if l.name.startswith("PDE") else l for l in jd.losses]
    return jns.OptimizationProblem(jd.model.variables, losses,
                                   jd.losses_test, callbacks=[])


def _jax_rounds(pb, rounds):
    for name, n in rounds:
        if name == "keras":
            jns.minimize(pb, "keras", jns.optimizers.Adam(learning_rate=1e-2),
                         num_epochs=n)
        else:
            from tpinn.driver import run_second_round

            run_second_round(pb, name, n)
    return pb.history


# the port's jobs at 3 ranks, by name: (driver kwargs, rounds, env)
ROUND_JOBS = {
    "bfgs_plain": ("none", [["keras", ADAM], ["jax-bfgs", BFGS]], {}),
    "bfgs_paired": ("none", [["keras", ADAM], ["jax-bfgs", BFGS]],
                    {"TPINN_USE_PALLAS": "0"}),
    "lbfgs": ("none", [["keras", ADAM], ["jax", LBFGS]], {}),
    "lm": ("lm", [["keras", ADAM], ["lm", LM]], {}),
    "scipy": ("none", [["keras", ADAM], ["scipy-parity", SCIPY]], {}),
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """tpinn's data, its evaluations at θ0 (unsharded and on 3 and 8
    devices) and its unsharded histories."""
    out = {"arrays": {}, "eval": {}, "hist": {}, "step": {},
           "base": str(tmp_path_factory.mktemp("dryrun"))}
    for opts in OPTS:
        jd = _jax_driver(opts)
        out["arrays"][opts] = lm._arrays(jd)
        out["eval"][(opts, 1)] = _jax_eval(jd)
        for w in (3, 8):
            out["eval"][(opts, w)] = _jax_eval(
                _jax_driver(opts, mesh=jsh.point_mesh(w)))
    for name, (second, rounds, env) in ROUND_JOBS.items():
        jd = _jax_driver("70", second_round="lm" if second == "lm" else
                         "jax-bfgs")
        pb = (_wrapped_plain(jd) if name == "bfgs_plain" else
              jns.OptimizationProblem(jd.model.variables, jd.losses,
                                      jd.losses_test, callbacks=[]))
        out["hist"][name] = _jax_rounds(pb, rounds)
        if name == "lm":
            assert pb.lm_used_fast_gram
    # the dry run's paths 3-4 (__graft_entry__.py) unsharded, their draws
    # for the port's ranks; path 2's flagship θ0 and the unsharded kernel's
    # loss on the true rows of the 64·n − 5-row batch
    for path, opts, second, adam in ((3, entry.PATH3, "jax", 15),
                                     (4, entry.PATH4, "lm", 10)):
        jd = JaxDriver(dataclasses.replace(graft._poiseuille_spec(),
                                           width=DRYRUN_WIDTH),
                       JaxOptions(**opts), base_dir=out["base"],
                       save_results=False, seed=0, second_round=second,
                       adam_epochs=adam)
        out["arrays"][str(path)] = lm._arrays(jd)
        out["hist"][f"path{path}"] = jd.train(callbacks=False).history
        if path == 4:
            assert jd.pb.lm_used_fast_gram
    model, norm, physics = graft._flagship()
    out["flagship"] = [{k: np.asarray(p[k]) for k in ("kernel", "bias")}
                       for p in model.params]
    for w in (3, 8):
        batch = np.random.default_rng(0).uniform(0, 1, (64 * w, 2))
        for dt in ("float32", "float64"):
            p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                       model.params)
            m = jax_ns_mse(p, jnp.asarray(batch[:64 * w - 5], dt), physics,
                           norm, interpret=True)
            out["step"][(w, dt)] = float(10.0 * m[0] + m[1] + m[2])
    spec = _spec()
    spec.pressure_gauge = "mean"
    jd = _jax_driver("70", spec=spec)
    assert jd.losses[-1].name == "PRESS_0"
    out["eval"]["press"] = _jax_eval(jd)
    out["hist"]["press"] = _jax_rounds(jns.OptimizationProblem(
        jd.model.variables, jd.losses, jd.losses_test, callbacks=[]),
        [["keras", ADAM]])
    return out


def _job(arrays, second="none", **kw):
    return dict({"case": CASE, "spec": SPEC, "opts": OPTS["70"],
                 "arrays": arrays,
                 "driver": {"device": "cpu", "save_results": False,
                            "seed": 0, "adam_epochs": ADAM,
                            "second_round": second}}, **kw)


def _spawn(nprocs, jobs, tmp):
    sharding.spawn(sharded_runs.run_jobs, nprocs, args=(jobs, str(tmp)),
                   timeout=TIMEOUT, deadline=DEADLINE)
    return sharded_runs.load(str(tmp), nprocs)


@pytest.fixture(scope="module")
def w3(ref, tmp_path_factory):
    """Every 3-rank job in one spawn, by name: per job the results of every
    rank."""
    a = ref["arrays"]["70"]
    base = str(tmp_path_factory.mktemp("runs"))
    jobs = {"eval 64": _job(ref["arrays"]["64"], opts=OPTS["64"], eval=True),
            "eval 70": _job(a, eval=True)}
    for name, (second, rounds, env) in ROUND_JOBS.items():
        jobs[name] = _job(a, second, rounds=rounds, env=env)
    jobs["press"] = _job(a, spec=dict(SPEC, pressure_gauge="mean"),
                         eval=True, rounds=[["keras", ADAM]])
    saved = dict(a, params=a["params"])
    jobs["saved"] = _job(saved, "jax-bfgs", train={"epochs": BFGS},
                         save_artifacts=True)
    jobs["saved"]["driver"].update(save_results=True,
                                   base_dir=os.path.join(base, "saved"))
    resume = {"device": "cpu", "seed": 0, "adam_epochs": 0,
              "second_round": "jax-bfgs", "save_results": True,
              "base_dir": os.path.join(base, "resume")}
    jobs["first"] = _job(a, train={"epochs": RESUME}, driver=resume,
                         save_experiment=True)
    jobs["resumed"] = _job(a, train={"epochs": RESUME,
                                     "resume_from": "@prev"}, driver=resume)
    jobs["straight"] = _job(a, train={"epochs": 2 * RESUME,
                                      "callbacks": False},
                            driver=dict(resume, save_results=False))
    jobs.update(OWN_JOBS)
    jobs.update(_dryrun_jobs(ref))
    ranks = _spawn(3, list(jobs.values()), tmp_path_factory.mktemp("w3"))
    return {name: [r[i] for r in ranks] for i, name in enumerate(jobs)}


# the port's cases on their own draws (the Poiseuille spec with its Neumann
# outflow), 3 ranks against one process
OWN_DRIVER = {"device": "cpu", "save_results": False, "seed": 0,
              "adam_epochs": 10}
OWN_JOBS = {
    "unsteady": {
        "case": CASE,
        "spec": {"grid_shape": (6, 4), "unsteady": True,
                 "time_horizon": 1.0, "dt": 0.25,
                 "physics": NSPhysics(conv=3.1, visc=0.89, time=1.0)},
        "opts": dict(epochs=0, n_pde=50, n_bc=7, n_ic=10, n_vel=5, n_pres=0,
                     n_test=20),
        "driver": dict(OWN_DRIVER, second_round="jax-bfgs"),
        "rounds": [["keras", 10], ["jax-bfgs", 5]]},
    "neumann_lm": {
        "case": CASE, "spec": {"grid_shape": (20, 10)},
        "opts": OPTS["70"], "driver": dict(OWN_DRIVER, second_round="lm"),
        "rounds": [["keras", 0], ["lm", 2]]},
}


def _dryrun_jobs(ref):
    """The dry run's jobs by name: path 2 on tpinn's flagship θ0, paths 3-4
    on its draws."""
    jobs = entry.dryrun_jobs(ref["base"], "cpu",
                             {p: ref["arrays"][p] for p in "34"},
                             ref["flagship"])
    for job in jobs[2:]:
        job["spec"] = {"width": DRYRUN_WIDTH}
    return dict(zip(("step float32", "step float64", "path3", "path4"),
                    jobs))


@pytest.fixture(scope="module")
def w8(ref, tmp_path_factory):
    jobs = {o: _job(ref["arrays"][o], opts=OPTS[o], eval=True) for o in OPTS}
    jobs.update(_dryrun_jobs(ref))
    ranks = _spawn(8, list(jobs.values()), tmp_path_factory.mktemp("w8"))
    return {name: [r[i] for r in ranks] for i, name in enumerate(jobs)}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _check_eval(got, want):
    total, train, test = got
    assert _rel(total, want[0]) < EVAL_BAR
    raws = {**train, **test}
    assert sorted(raws) == sorted(want[1])
    for name, v in want[1].items():
        assert _rel(raws[name], v) < EVAL_BAR, name


def _logs(history):
    """A history dict without its wall-clock seconds."""
    return {k: v for k, v in history.items() if k != "log_rounds"}


def _same_on_every_rank(ranks):
    for r in ranks[1:]:
        assert r["thetas"] == ranks[0]["thetas"]
        assert _logs(r["history"]) == _logs(ranks[0]["history"])


@pytest.mark.parametrize("world", [3, 8])
@pytest.mark.parametrize("opts", list(OPTS))
def test_eval_at_theta0_equals_tpinn(ref, w3, w8, world, opts):
    ranks = w3[f"eval {opts}"] if world == 3 else w8[opts]
    for r in ranks:
        assert r["eval"] == ranks[0]["eval"]
    for key in ((opts, 1), (opts, world)):
        _check_eval(ranks[0]["eval"], ref["eval"][key])


def _dev(hj, h, rounds):
    """The largest relative deviation of every log of the rounds (by
    index, from 1)."""
    sel = [i for i, r in enumerate(h.rounds_idx) if r in rounds]
    devs = [np.max(np.abs(np.array(h.loss_global)[sel]
                          - np.array(hj.loss_global)[sel])
                   / np.abs(np.array(hj.loss_global)[sel]))]
    for group in ("losses", "losses_test"):
        for name, e in getattr(hj, group).items():
            a = np.array(e["log"])[sel]
            b = np.array(getattr(h, group)[name]["log"])[sel]
            devs.append(np.max(np.abs(b - a) / np.abs(a)))
    return float(max(devs))


@pytest.mark.parametrize("name", list(ROUND_JOBS))
def test_rounds_equal_tpinn_unsharded(ref, w3, name):
    ranks = w3[name]
    _same_on_every_rank(ranks)
    assert len(ranks[0]["thetas"]) == 2  # θ after each round
    h = History.from_dict(ranks[0]["history"])
    hj = ref["hist"][name]
    assert h.round_names == hj.round_names
    assert h.iters == hj.iters
    assert _dev(hj, h, {1}) < ADAM_BAR
    assert _dev(hj, h, {2}) < ROUND_BAR
    assert h.loss_global[-1] < h.loss_global[0]
    if name == "lm":
        assert all(r["lm_used_fast_gram"] for r in ranks)


def test_press_gauge_counts_once(ref, w3):
    ranks = w3["press"]
    _same_on_every_rank(ranks)
    _check_eval(ranks[0]["eval"], ref["eval"]["press"])
    h = History.from_dict(ranks[0]["history"])
    assert "PRESS_0" in h.losses
    assert _dev(ref["hist"]["press"], h, {1}) < ADAM_BAR


def test_save_results_writes_once(ref, w3):
    ranks = w3["saved"]
    _same_on_every_rank(ranks)
    folder = ranks[0]["folder"]
    assert all(r["folder"] == folder for r in ranks)
    assert [r["callbacks"] for r in ranks] == [2, 0, 0]
    base = os.path.dirname(folder)
    assert os.listdir(base) == ["Test_Case_#001"]
    # tpinn's file set; no loss groups, so no Loss_Trend_Reduced.png
    assert sorted(os.listdir(folder)) == [
        f for f in ARTIFACTS if f != "Loss_Trend_Reduced.png"]
    with open(os.path.join(folder, "History_Loss.json")) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(ranks[0]["history"]))
    # the same rounds as the main path's job, so the same bits, and within
    # the bars of tpinn's unsharded history
    assert saved["log"]["loss_global"] == \
        w3["bfgs_plain"][0]["history"]["log"]["loss_global"]
    h = History.from_dict(saved)
    assert _dev(ref["hist"]["bfgs_plain"], h, {1}) < ADAM_BAR
    assert _dev(ref["hist"]["bfgs_plain"], h, {2}) < ROUND_BAR


def test_resume_on_the_mesh_equals_straight(w3):
    first, resumed, straight = (w3[k] for k in ("first", "resumed",
                                                "straight"))
    for ranks in (first, resumed, straight):
        _same_on_every_rank(ranks)
    assert resumed[0]["folder"] == first[0]["folder"]
    hr = History.from_dict(resumed[0]["history"])
    hs = History.from_dict(straight[0]["history"])
    assert hr.round_names == ["keras_Adam", "jax_BFGS", "jax_BFGS"]
    assert resumed[0]["thetas"][-1] == straight[0]["thetas"][-1]
    assert hr.loss_global[-1] == hs.loss_global[-1]
    for group in ("losses", "losses_test"):
        for name, e in getattr(hs, group).items():
            assert getattr(hr, group)[name]["log"][-1] == e["log"][-1]


@pytest.mark.parametrize("name", list(OWN_JOBS))
def test_own_cases_equal_one_process(w3, name):
    ranks = w3[name]
    _same_on_every_rank(ranks)
    ref = sharded_runs.run_job(0, None, OWN_JOBS[name])
    h, hr = (History.from_dict(r["history"]) for r in (ranks[0], ref))
    assert h.iters == hr.iters and list(h.losses) == list(hr.losses)
    assert any(n.startswith("BCN_") for n in h.losses)
    if name == "unsteady":
        assert {"IC_u", "IC_v", "IC_p"} <= set(h.losses)
    else:
        assert all(r["lm_used_fast_gram"] for r in ranks)
    assert _dev(hr, h, {1}) < ADAM_BAR
    assert _dev(hr, h, {2}) < ROUND_BAR


@pytest.mark.parametrize("world", [3, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dryrun_step_equals_tpinn(ref, w3, w8, world, dtype):
    ranks = (w3 if world == 3 else w8)[f"step {dtype}"]
    for r in ranks[1:]:
        assert (r["theta"], r["l1"], r["l2"]) == (
            ranks[0]["theta"], ranks[0]["l1"], ranks[0]["l2"])
    step = ranks[0]
    assert step["n_true"] == 64 * world - 5
    assert entry.step_ok(step)
    bar = entry.STEP_BARS[getattr(torch, dtype)][2]
    assert abs(step["l1"] / ref["step"][(world, dtype)] - 1.0) < bar


@pytest.mark.parametrize("world", [3, 8])
@pytest.mark.parametrize("path", [3, 4])
def test_dryrun_paths_equal_tpinn_unsharded(ref, w3, w8, world, path):
    ranks = (w3 if world == 3 else w8)[f"path{path}"]
    _same_on_every_rank(ranks)
    h = History.from_dict(ranks[0]["history"])
    hj = ref["hist"][f"path{path}"]
    assert h.round_names == hj.round_names == [
        "keras_Adam", "jax_L-BFGS" if path == 3 else "jax_LM"]
    assert h.iters == hj.iters
    assert _dev(hj, h, {1}) < ADAM_BAR
    assert _dev(hj, h, {2}) < ROUND_BAR
    if path == 4:
        assert all(r["lm_used_fast_gram"] for r in ranks)
