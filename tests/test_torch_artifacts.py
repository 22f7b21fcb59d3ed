"""The port's run artifacts, checkpoints, callbacks and exact resume,
against the JAX package's on the CPU in float64.

* tpinn's Model.json + Weights.h5 load into the port, whose outputs then
  agree within 1e-13; the port's own .h5 and .npz files round-trip bit for
  bit, and tpinn reads them; Model.json has tpinn's fields (all but
  ``backend``); Test_Options.txt is byte-equal to tpinn's; a driver's
  ``save_artifacts`` writes tpinn's file set; without h5py the weights go
  to Weights.npz, and without matplotlib the case writes the experiment and
  the recap but no figure;
* the callbacks fire by rate, not by alignment, and a failed plot does not
  stop the history flush;
* the resume contract of tests/test_optimize_resume.py (a stale carry is
  discarded, checkpoints hold the in-flight parameters, the iteration-0
  flush keeps an adopted carry, a state of another kind stays for its
  round), on float64 problems;
* 20 BFGS iterations straight equal 10, ``save_experiment``, and 10 more
  after ``train(resume_from=...)`` in a new driver, bit for bit;
* tpinn runs 10 BFGS iterations and saves its run folder; both packages
  resume from it for 10 more, their histories within 1e-8 relative.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tpinn import checkpoint as jax_ckpt
from tpinn import experiment as jax_experiment
from tpinn.models import MLP as JaxMLP
from tpinn.models import model_from_json as jax_model_from_json
from tpinn_torch import checkpoint, experiment, utils
from tpinn_torch.cases import poiseuille_flow as pf
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import StandardNSDriver
from tpinn_torch.models import MLP, model_from_json
from tpinn_torch.optimize import minimize
from tests import test_torch_lm as lm
from tests.test_torch_bfgs import _tiny_problem

torch.set_num_threads(1)

HISTORY_BAR = 1e-8
ARTIFACTS = ["Graphic.jpg", "History_Loss.json", "Loss_Trend_Full.png",
             "Loss_Trend_Reduced.png", "Model.json", "Test_Options.txt",
             "Weights.h5", "checkpoint.pkl"]


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _jax_model():
    return JaxMLP(2, 3, width=32, depth=3, seed=5,
                  input_extents=[(0.0, 1.0), (0.0, 0.1)])


def _points(n=200):
    rng = np.random.default_rng(2)
    return rng.uniform(0, 1, (n, 2)) * np.array([1.0, 0.1])


# ---------------------------------------------------------------------------
# Model.json and the weights
# ---------------------------------------------------------------------------

def test_tpinn_model_files_load_into_port(tmp_path):
    jm = _jax_model()
    with open(tmp_path / "Model.json", "w") as f:
        f.write(jm.to_json())
    jm.save_weights(str(tmp_path / "Weights.h5"))
    model, history = checkpoint.load_experiment(str(tmp_path), device="cpu")
    assert history is None
    assert model.layer_sizes == (2, 32, 32, 32, 3)
    assert model.dtype == torch.float64
    x = _points()
    ref = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = model(x).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-13 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", ["Weights.h5", "Weights.npz"])
def test_port_weights_round_trip(tmp_path, name):
    model = MLP(2, 3, seed=4, device="cpu")
    model.save_weights(str(tmp_path / name))
    other = MLP(2, 3, seed=9, device="cpu")
    other.load_weights(str(tmp_path / name))
    for a, b in zip(model.flat_params(), other.flat_params()):
        assert torch.equal(a, b)
    # tpinn reads the port's files
    jm = JaxMLP(2, 3, width=32, depth=3, seed=1)
    jm.load_weights(str(tmp_path / name))
    for p, q in zip(jm.params, model.params):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(p[k]),
                                          q[k].detach().numpy())


def test_model_json_fields_match_tpinn():
    jm = _jax_model()
    model = MLP(2, 3, seed=5, device="cpu")
    ours, theirs = json.loads(model.to_json()), json.loads(jm.to_json())
    assert ours.pop("backend") == "torch" and theirs.pop("backend") == "jax"
    assert ours == theirs
    # each package rebuilds the other's architecture
    again = jax_model_from_json(model.to_json())
    assert tuple(again.layer_sizes) == model.layer_sizes
    back = model_from_json(jm.to_json(), device="cpu")
    assert back.layer_sizes == model.layer_sizes
    assert back.activation_name == "tanh" and back.dtype == torch.float64


@pytest.mark.parametrize("extra", [None, {"Second round": "jax-bfgs"}])
def test_recap_is_byte_equal(tmp_path, extra):
    opts = pf.default_options()
    for pkg, sub in ((experiment, "port"), (jax_experiment, "jax")):
        os.makedirs(tmp_path / sub)
        pkg.write_recap(str(tmp_path / sub), "Poiseuille_Flow", opts.epochs,
                        opts.n_pts, noise_fit=0.01, noise_bnd=0.0,
                        extra=extra, echo=False)
    assert ((tmp_path / "port" / "Test_Options.txt").read_bytes()
            == (tmp_path / "jax" / "Test_Options.txt").read_bytes())


# ---------------------------------------------------------------------------
# the driver's artifacts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """tpinn's small Poiseuille driver (the options of test_torch_lm) and
    its data."""
    tmp = tmp_path_factory.mktemp("artifacts")
    jex = lm._jax_example()
    return jex, lm._arrays(lm._jax_driver(jex, tmp, adam_epochs=0,
                                          second_round="jax-bfgs")), tmp


def test_save_artifacts_writes_tpinn_file_set(small, tmp_path):
    jex, arrays, _ = small
    jd = lm._jax_driver(jex, tmp_path / "jax", adam_epochs=2,
                        second_round="none")
    jd.train()
    jd.save_artifacts(loss_groups=jex.LOSS_GROUPS)
    td = lm._port_driver(arrays, tmp_path / "port", second_round="none")
    td.train()
    td.save_artifacts(loss_groups=pf.LOSS_GROUPS)
    assert sorted(os.listdir(jd.folder)) == sorted(os.listdir(td.folder)) \
        == ARTIFACTS
    assert pf.LOSS_GROUPS == jex.LOSS_GROUPS
    # the experiment reloads: the model bit for bit, the history whole
    model, history = checkpoint.load_experiment(td.folder, device="cpu")
    for a, b in zip(model.flat_params(), td.model.flat_params()):
        assert torch.equal(a, b)
    assert history.loss_global == td.pb.history.loss_global
    gx, gy, u, v, p = td.predict_grid(n=10)
    assert gx.shape == u.shape == (10, 10) and np.isfinite(p).all()


def test_without_h5py_and_matplotlib(tmp_path, monkeypatch):
    """The card's host: the weights go to Weights.npz (and load from it),
    the case writes the experiment and the recap, and the figures are
    left out without stopping the run."""
    real = utils.has_module
    monkeypatch.setattr(utils, "has_module", lambda name: False if name in (
        "h5py", "matplotlib") else real(name))

    def no_plot(*a, **k):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(utils, "_plot_history_dict", no_plot)
    opts = SimulationOptions(**{**pf.default_options().__dict__,
                                **lm.SMALL})
    monkeypatch.setattr(pf, "default_options", lambda: opts)
    drv = pf.main(str(tmp_path), adam_epochs=3, device="cpu",
                  second_round="jax-bfgs", epochs=2)
    assert sorted(os.listdir(drv.folder)) == [
        "History_Loss.json", "Model.json", "Test_Options.txt",
        "Weights.npz", "checkpoint.pkl"]
    model, history = checkpoint.load_experiment(drv.folder, device="cpu")
    for a, b in zip(model.flat_params(), drv.model.flat_params()):
        assert torch.equal(a, b)
    assert history.round_names == ["keras_Adam", "jax_BFGS"]


# ---------------------------------------------------------------------------
# callbacks
# ---------------------------------------------------------------------------

def test_callbacks_fire_by_rate(tmp_path, monkeypatch):
    model, pb = _tiny_problem()
    cb = utils.CheckpointCallback(tmp_path / "c.pkl", frequency=100)
    fired = []
    monkeypatch.setattr(checkpoint, "save_checkpoint",
                        lambda path, params, **kw: fired.append(
                            kw["extra"]["iteration"]))
    # a resumed round starting at 20102: no iteration is a multiple of 100
    for it in range(20102, 20400, 10):
        cb(pb, it)
    cb(pb, 20395, force=True)
    assert fired == [20102, 20202, 20302, 20395]
    assert utils.CheckpointCallback(tmp_path / "d.pkl", frequency=0)._due(
        5, False) is False


def test_history_flush_survives_a_failed_plot(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no display")

    monkeypatch.setattr(utils, "_plot_history_dict", broken)
    model, pb = _tiny_problem()
    pb.callbacks.append(utils.HistoryPlotCallback(
        frequency=1, filename=str(tmp_path / "h.png"),
        filename_history=str(tmp_path / "h.json")))
    minimize(pb, "jax", "BFGS", num_epochs=3)
    assert json.loads((tmp_path / "h.json").read_text())["log"]["iter"] \
        == pb.history.iters == [0, 3]
    assert not (tmp_path / "h.png").exists()


# ---------------------------------------------------------------------------
# the resume contract
# ---------------------------------------------------------------------------

def _restart(tmp_path, model, pb):
    """A process restart: the parameters and the tagged state through the
    checkpoint pickle into a fresh problem."""
    path = tmp_path / "checkpoint.pkl"
    checkpoint.save_checkpoint(path, model.params,
                               opt_state=pb.last_opt_state)
    state = checkpoint.load_checkpoint(path)
    model2, pb2 = _tiny_problem()
    model2.set_params([{k: torch.as_tensor(p[k]) for k in p}
                       for p in state["params"]])
    pb2.resume_opt_state = state["opt_state"]
    return model2, pb2


def test_stale_resume_state_is_discarded(tmp_path):
    model, pb = _tiny_problem()
    minimize(pb, "jax", "BFGS", num_epochs=20)
    stale = checkpoint.to_numpy(pb.last_opt_state)
    model2, pb2 = _tiny_problem()  # fresh parameters, not the carry's
    pb2.resume_opt_state = stale
    minimize(pb2, "jax", "BFGS", num_epochs=30)
    assert pb2.resume_opt_state is None
    model3, pb3 = _tiny_problem()
    minimize(pb3, "jax", "BFGS", num_epochs=30)  # a cold start
    assert pb2.history.loss_global == pb3.history.loss_global
    assert pb2.history.loss_global[-1] < 1e-12


def test_checkpoint_callback_snapshots_inflight_params(tmp_path):
    model, pb = _tiny_problem()
    start = pb.get_vector()
    path = tmp_path / "ckpt.pkl"
    pb.callbacks.append(utils.CheckpointCallback(path, frequency=1))
    seen = []
    pb.callbacks.append(lambda pb_, it, force=False: seen.append(
        (it, checkpoint.load_checkpoint(path)["params"])))
    minimize(pb, "jax", "BFGS", num_epochs=10)
    flat = np.concatenate([np.concatenate([p["bias"], p["kernel"].ravel()])
                           for p in checkpoint.load_checkpoint(path)["params"]])
    assert not np.array_equal(flat, start)
    np.testing.assert_array_equal(flat, pb.get_vector())
    # the mid-round flush (iteration 10, before the end) held iteration 10
    it10 = [p for it, p in seen if it == 10][0]
    np.testing.assert_array_equal(it10[0]["kernel"],
                                  model.params[0]["kernel"].detach().numpy())


class _OptStateRecorder:
    def __init__(self):
        self.snaps = []

    def __call__(self, pb, iteration, force=False):
        st = pb.last_opt_state
        self.snaps.append((iteration, None if st is None else dict(st)))


def test_iter0_flush_keeps_the_adopted_state(tmp_path):
    model, pb = _tiny_problem()
    minimize(pb, "jax", "BFGS", num_epochs=5)
    saved = pb.last_opt_state["carry"]
    model2, pb2 = _restart(tmp_path, model, pb)
    rec = _OptStateRecorder()
    pb2.callbacks.append(rec)
    minimize(pb2, "jax", "BFGS", num_epochs=1)
    it0, st0 = rec.snaps[0]
    assert st0 is not None and st0["kind"] == "bfgs_paired"
    for a, b in zip(st0["carry"], saved):
        assert torch.equal(a, b)  # the adopted carry, not a fresh one
    assert pb2.resume_opt_state is None


def test_kind_mismatch_preserves_resume_state_for_later_round():
    model, pb = _tiny_problem()
    lm_state = {"kind": np.array("lm"), "theta64": pb.get_vector(),
                "mu": np.array(1e-3)}
    pb.resume_opt_state = lm_state
    minimize(pb, "jax", "BFGS", num_epochs=1)
    assert pb.resume_opt_state is lm_state


# ---------------------------------------------------------------------------
# exact resume of the Poiseuille driver
# ---------------------------------------------------------------------------

def _seeded_driver(tmp):
    opts = SimulationOptions(**{**pf.default_options().__dict__,
                                **lm.SMALL})
    return StandardNSDriver(pf.build_spec(), opts, base_dir=str(tmp),
                            device="cpu", seed=0, adam_epochs=10,
                            second_round="jax-bfgs")


def _series(h, sel):
    out = [np.array(h.loss_global)[sel]]
    for group in (h.losses, h.losses_test):
        out += [np.array(e["log"])[sel] for e in group.values()]
    return np.stack(out)


def test_resume_equals_straight_round_bit_for_bit(tmp_path):
    straight = _seeded_driver(tmp_path / "a")
    hs = straight.train(epochs=20).history
    first = _seeded_driver(tmp_path / "b")
    first.train(epochs=10)
    first.save_experiment()
    resumed = _seeded_driver(tmp_path / "b")
    hr = resumed.train(epochs=10, resume_from=first.folder).history
    assert resumed.folder == first.folder
    assert hs.round_names == ["keras_Adam", "jax_BFGS"]
    assert hr.round_names == ["keras_Adam", "jax_BFGS", "jax_BFGS"]
    assert resumed.pb.resume_opt_state is None  # the carry was adopted
    # straight: the BFGS logs at 0, 10, 20; resumed: 0, 10, then the new
    # round's 0 (iteration 10 again) and 10
    s = _series(hs, [i for i, r in enumerate(hs.rounds_idx) if r == 2])
    r2 = [i for i, r in enumerate(hr.rounds_idx) if r == 2]
    r3 = [i for i, r in enumerate(hr.rounds_idx) if r == 3]
    assert len(r2) == len(r3) == 2
    np.testing.assert_array_equal(_series(hr, r2), s[:, :2])
    np.testing.assert_array_equal(_series(hr, r3), s[:, 1:])
    for a, b in zip(straight.model.flat_params(), resumed.model.flat_params()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def tpinn_run(small, tmp_path_factory):
    """tpinn's paired BFGS round, 10 iterations, saved as a run folder, and
    tpinn's own resume from a copy of it for 10 more."""
    jex, arrays, _ = small
    tmp = tmp_path_factory.mktemp("resume")
    jd = lm._jax_driver(jex, tmp, adam_epochs=0, second_round="jax-bfgs")
    jpb = jd.train(epochs=10, callbacks=False)
    jax_ckpt.save_experiment(jd.folder, jd.model, jpb.history,
                             opt_state=jpb.last_opt_state)
    weights = os.path.join(jd.folder, "Weights.h5")
    # tpinn reads checkpoint.pkl only when it is strictly newer than the
    # weights, and the two may land within one tick of the file clock
    t = os.path.getmtime(weights) + 1.0
    os.utime(os.path.join(jd.folder, "checkpoint.pkl"), (t, t))
    port_copy = str(tmp / "port_copy")
    shutil.copytree(jd.folder, port_copy)
    jd2 = lm._jax_driver(jex, tmp, adam_epochs=0, second_round="jax-bfgs")
    resumed = jd2.train(epochs=10, callbacks=False, resume_from=jd.folder)
    return port_copy, resumed


def test_both_packages_resume_tpinn_run(small, tpinn_run, monkeypatch):
    jex, arrays, tmp = small
    port_copy, jres = tpinn_run
    monkeypatch.setenv("TPINN_USE_PALLAS", "0")  # the paired variant
    td = lm._port_driver(arrays, tmp, second_round="jax-bfgs")
    tpb = td.train(epochs=10, callbacks=False, resume_from=port_copy)
    assert tpb.resume_opt_state is None  # tpinn's carry was adopted
    assert tpb.last_opt_state["kind"] == str(jres.last_opt_state["kind"]) \
        == "bfgs_paired"
    h, hj = tpb.history, jres.history
    assert h.round_names == hj.round_names == ["keras_Adam", "jax_BFGS",
                                               "jax_BFGS"]
    assert h.iters == hj.iters
    assert lm._max_rel_dev(hj, h) < HISTORY_BAR


if __name__ == "__main__":
    # The deviations behind the bars above, from the repo root:
    #   JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
    #       python tests/test_torch_artifacts.py
    import tempfile
    from pathlib import Path

    import jax

    jax.config.update("jax_enable_x64", True)
    with threadpool_limits(limits=1, user_api="blas"), \
            tempfile.TemporaryDirectory() as td:
        jm = _jax_model()
        with open(Path(td) / "Model.json", "w") as f:
            f.write(jm.to_json())
        jm.save_weights(str(Path(td) / "Weights.h5"))
        model, _ = checkpoint.load_experiment(td, device="cpu")
        x = _points()
        ref = np.asarray(jm(jnp.asarray(x)))
        with torch.no_grad():
            err = np.max(np.abs(model(x).numpy() - ref))
        print(f"tpinn's Model.json + Weights.h5 in the port: max |Δ| of the "
              f"outputs {err:.3e} (max |ref| {np.abs(ref).max():.3e})")

        straight = _seeded_driver(Path(td) / "a")
        hs = straight.train(epochs=20).history
        first = _seeded_driver(Path(td) / "b")
        first.train(epochs=10)
        first.save_experiment()
        hr = _seeded_driver(Path(td) / "b").train(
            epochs=10, resume_from=first.folder).history
        s = _series(hs, [i for i, r in enumerate(hs.rounds_idx) if r == 2])
        r3 = _series(hr, [i for i, r in enumerate(hr.rounds_idx) if r == 3])
        print(f"20 straight against 10 + resume 10: largest difference "
              f"{np.max(np.abs(r3 - s[:, 1:])):.3e}")

        class _Factory:
            def mktemp(self, name):
                p = Path(td) / name
                p.mkdir()
                return p

        small_ = small.__wrapped__(_Factory())
        port_copy, jres = tpinn_run.__wrapped__(small_, _Factory())
        os.environ["TPINN_USE_PALLAS"] = "0"
        tpb = lm._port_driver(small_[1], small_[2], second_round="jax-bfgs") \
            .train(epochs=10, callbacks=False, resume_from=port_copy)
        print(f"tpinn's run folder resumed for 10 iterations by both "
              f"packages: max rel deviation of every log "
              f"{lm._max_rel_dev(jres.history, tpb.history):.3e}")
