"""The port's two old-style cavity scripts against the JAX package's, in
float64 on the CPU:

* ``tpinn_torch.cases.cavity_steady_csv`` against
  examples/Cavity_Steady/cavity_steady_csv.py on the committed csv data,
* ``tpinn_torch.cases.cavity_unsteady_old`` against
  examples/Cavity_Unsteady/cavity_unsteady_old.py on the committed series
  (at small point counts; tpinn's data step is pointed at the committed
  folder, so it writes nothing there).

From tpinn's θ0 and ``jax.random`` draws carried across: every loss at θ0
within 1e-12, 100 Adam epochs within 1e-10 and 5 iterations of the
scripts' L-BFGS branch within 1e-8.  The index subsets (Python's
``random``) and the grid are the ones tpinn's script draws, checked equal
rather than carried across.  Also the steady script's ``press_mode`` Mean
and None, its ``save_mode`` / ``load_mode`` round trip, and each script's
``main`` from a seed.
"""

import importlib.util
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tpinn.models import Model as JaxModel
from tpinn.models import model_from_json as jax_model_from_json
from tpinn.oracles import generate as jgen
from tpinn_torch import utils
from tpinn_torch.cases import cavity_steady_csv as csv_case
from tpinn_torch.cases import cavity_unsteady_old as old_case
from tpinn_torch.oracles import io as tio
from tests import test_torch_poisson_case as pc

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STEADY_DATA = os.path.join(_REPO, "examples", "Cavity_Steady", "data",
                            "SteadyCase")
_UNSTEADY_DATA = os.path.join(_REPO, "examples", "Cavity_Unsteady", "data",
                              "UnsteadyCase")
THETA0_BAR = 1e-12
ADAM_BAR = 1e-10
ROUND_BAR = 1e-8
ITERS = 5
SMALL = dict(num_PDE=200, num_BC=40, num_CI=60, num_col=30, num_pres=25,
             num_test=50)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _example(folder, name):
    path = os.path.join(_REPO, "examples", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{name}_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(jm):
    return [{k: np.asarray(p[k]) for k in ("kernel", "bias")}
            for p in jm.params]


def _link_files(src, folder):
    """``folder`` holding a symlink to each file of ``src``, so that files
    the port derives there stay out of the repository."""
    os.makedirs(folder)
    for name in os.listdir(src):
        os.symlink(os.path.join(src, name), os.path.join(folder, name))


def _check(hj, ht, rounds=("keras_Adam", "jax_L-BFGS")):
    assert ht.round_names == hj.round_names == list(rounds)
    assert ht.iters == hj.iters
    assert max(pc._rel_devs_at(hj, ht, [0])) < THETA0_BAR
    assert pc._rel_devs(hj, ht, {1}) < ADAM_BAR
    if len(rounds) > 1:
        assert pc._rel_devs(hj, ht, {2}) < ROUND_BAR


def _same_losses(jpb, tpb):
    assert [l.name for l in tpb.losses] == list(jpb.history.losses)
    assert [l.name for l in tpb.losses_test] == list(jpb.history.losses_test)
    for lj, lt in zip(jpb.losses, tpb.losses):
        assert (lt.weight, lt.normalization, lt.non_negative) == (
            lj.weight, lj.normalization, lj.non_negative)


# ---------------------------------------------------------------------------
# the csv-driven steady script
# ---------------------------------------------------------------------------

def _steady_draws(use_noise=False):
    """tpinn's boundary points and noise (cavity_steady_csv.py) and θ0."""
    dt = jnp.float64
    n = csv_case.NUM_BC
    ks = jax.random.split(jax.random.PRNGKey(1), 8)
    edge = lambda k, lo, hi: np.asarray(jax.random.uniform(
        k, (n, 2), dtype=dt, minval=jnp.asarray(lo, dt),
        maxval=jnp.asarray(hi, dt)))
    arrays = {"x_BC_x0": edge(ks[0], [0, 0], [0, 1]),
              "x_BC_x1": edge(ks[1], [1, 0], [1, 1]),
              "x_BC_y0": edge(ks[2], [0, 0], [1, 0]),
              "x_BC_y1": edge(ks[3], [0, 1], [1, 1])}
    noise = lambda k, m: (np.asarray(1e-1 * jax.random.normal(k, (m,), dt))
                          if use_noise else None)
    arrays.update(noise_x=noise(ks[4], 3 * n), noise_y=noise(ks[5], 3 * n),
                  noise_x_up=noise(ks[6], n), noise_y_up=noise(ks[7], n))
    jm = JaxModel([2, 32, 32, 64, 3], activation="tanh", seed=1,
                  input_extents=[(0.0, 1.0), (0.0, 1.0)])
    return arrays, _params(jm)


@pytest.fixture(scope="module")
def steady_data():
    """The committed csv through the port's loader (the committed folder
    is complete, so nothing is written there)."""
    folder, data = csv_case.load_data(os.path.join(_STEADY_DATA, "..", ".."),
                                      device="cpu")
    assert os.path.samefile(folder, _STEADY_DATA)
    assert data["x"].shape == (5000, 2)
    return data


@pytest.mark.parametrize("press_mode,use_noise",
                         [("Collocation", True), ("Mean", False),
                          ("None", False)])
def test_steady_csv_matches_tpinn(tmp_path, steady_data, press_mode,
                                  use_noise):
    """The Collocation run takes 5 L-BFGS iterations after Adam; the Mean
    and None runs the Adam round alone."""
    second = "jax" if press_mode == "Collocation" else "none"
    jex = _example("Cavity_Steady", "cavity_steady_csv")
    jpb, _ = jex.main(epochs=ITERS, use_noise=use_noise,
                      press_mode=press_mode, second_round=second,
                      save_plots=False, out_dir=str(tmp_path))
    arrays, params = _steady_draws(use_noise)
    tpb, _ = csv_case.from_arrays(arrays, params, steady_data, device="cpu",
                                  press_mode=press_mode)
    _same_losses(jpb, tpb)
    names = [l.name for l in tpb.losses]
    assert names[-1] == {"Collocation": "COL_p", "Mean": "MEAN_p",
                         "None": "COL_v"}[press_mode]
    csv_case.train(tpb, ITERS, second)
    _check(jpb.history, tpb.history,
           ("keras_Adam", "jax_L-BFGS") if second == "jax"
           else ("keras_Adam",))
    with pytest.raises(ValueError, match="press_mode"):
        csv_case.build(tpb.model, steady_data, {}, press_mode="Gauge")


def test_steady_csv_save_then_load(tmp_path, monkeypatch):
    """``save_mode`` writes Saved_Model/<name>.json and .h5 (tpinn's
    model_from_json / load_weights read them), ``load_mode`` reads them
    back bit for bit without training; without h5py the weights go to an
    npz.  The history and the figures land in OUT/Images."""
    out = str(tmp_path)
    _link_files(_STEADY_DATA, os.path.join(out, "data", "SteadyCase"))
    pb, model = csv_case.main(epochs=2, second_round="jax", out_dir=out,
                              save_mode=True, model_name_save="m",
                              device="cpu", press_mode="Mean")
    images = set(os.listdir(os.path.join(out, "Images")))
    assert f"{csv_case.problem_name}_history_loss.json" in images
    if utils.has_module("matplotlib"):
        assert f"{csv_case.problem_name}_Contours.png" in images
    assert sorted(os.listdir(os.path.join(out, "Saved_Model"))) == [
        "m.h5", "m.json"]
    assert pb.history.round_names == ["keras_Adam", "jax_L-BFGS"]
    x = np.random.default_rng(0).uniform(0, 1, (64, 2))
    with torch.no_grad():
        want = model(x).numpy()
    _, loaded = csv_case.main(out_dir=out, load_mode=True,
                              model_name_load="m", device="cpu",
                              save_plots=False)
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(x).numpy(), want)
    saved = os.path.join(out, "Saved_Model")
    with open(os.path.join(saved, "m.json")) as f:
        jm = jax_model_from_json(f.read())
    jm.load_weights(os.path.join(saved, "m.h5"))
    np.testing.assert_allclose(np.asarray(jm(jnp.asarray(x))), want,
                               rtol=1e-12, atol=1e-14)
    # without h5py the steady fields are read from an npz beside the h5
    folder = os.path.join(out, "data", "SteadyCase")
    tio.write_fields(tio.steady_path(folder, ".npz"),
                     *tio.read_fields(tio.steady_path(folder)))
    monkeypatch.setattr(utils, "has_module", lambda name: False)
    csv_case.main(epochs=0, second_round="none", out_dir=out, save_mode=True,
                  model_name_save="n", device="cpu", save_plots=False)
    assert {"n.npz", "n.json"} <= set(os.listdir(saved))
    _, loaded = csv_case.main(out_dir=out, load_mode=True,
                              model_name_load="n", device="cpu",
                              save_plots=False)
    assert loaded.layer_sizes == (2, 32, 32, 64, 3)
    with pytest.raises(ValueError, match="out_dir"):
        csv_case.main(device="cpu")


# ---------------------------------------------------------------------------
# the old unsteady script
# ---------------------------------------------------------------------------

def _unsteady_draws(sizes, use_noise=True):
    """tpinn's boundary / initial points and noise (cavity_unsteady_old.py)
    and θ0."""
    dt = jnp.float64
    T = old_case.T
    ks = jax.random.split(jax.random.PRNGKey(1), 9)
    box = lambda k, n, lo, hi: np.asarray(jax.random.uniform(
        k, (n, 3), dtype=dt, minval=jnp.asarray(lo, dt),
        maxval=jnp.asarray(hi, dt)))
    n = sizes["num_BC"]
    arrays = {"x_BC_x0": box(ks[0], n, [0, 0, 0], [T, 0, 1]),
              "x_BC_x1": box(ks[1], n, [0, 1, 0], [T, 1, 1]),
              "x_BC_y0": box(ks[2], n, [0, 0, 0], [T, 1, 0]),
              "x_BC_y1": box(ks[3], n, [0, 0, 1], [T, 1, 1]),
              "x_CI": box(ks[4], sizes["num_CI"], [0, 0, 0], [0, 1, 1])}
    for i, e in enumerate(old_case.EDGES):
        kx, ky = jax.random.split(ks[5 + i])
        for c, k in zip("uv", (kx, ky)):
            arrays[f"noise_{e}_{c}"] = (
                np.asarray(1e-1 * jax.random.normal(k, (n,), dtype=dt))
                if use_noise else None)
    jm = JaxModel([3, 32, 32, 32, 3], activation="tanh", seed=1,
                  input_extents=[(0.0, T), (0.0, 1.0), (0.0, 1.0)])
    return arrays, _params(jm)


@pytest.fixture(scope="module")
def unsteady(tmp_path_factory):
    """tpinn's script at small point counts (100 Adam epochs, 5 L-BFGS
    iterations) on the committed series, and the series through the port's
    reader."""
    jex = _example("Cavity_Unsteady", "cavity_unsteady_old")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen, "generate_cavity_unsteady",
                   lambda *a, **kw: _UNSTEADY_DATA)
        jpb, _ = jex.main(epochs=ITERS, second_round="jax", save_plots=False,
                          out_dir=str(tmp_path_factory.mktemp("old")),
                          **SMALL)
    series = tio.read_unsteady_series(_UNSTEADY_DATA, old_case.NUM_TIMES)
    return jpb, series


def test_grid_and_subsets_are_tpinns():
    """The grid is the (t, x, y) grid tpinn's script builds, and the index
    subsets are its ``random.seed(1)`` + ``random.sample`` draws."""
    n1 = 100
    time_vector = np.arange(0.0, old_case.T, step=old_case.DT)
    xs = np.linspace(0.0, 1.0, n1 + 1)
    tt, jj, ii = np.meshgrid(time_vector, xs, xs, indexing="ij")
    var = old_case.space_time_grid()
    np.testing.assert_array_equal(
        var, np.stack([tt.ravel(), ii.ravel(), jj.ravel()], axis=1))
    assert var.shape == (1_020_100, 3) and old_case.NUM_TIMES == 100
    state = random.getstate()
    try:
        random.seed(1)
        sequence = list(range(len(var)))
        ref = [random.sample(sequence, SMALL[f"num_{k}"])
               for k in old_case.SUBSETS]
    finally:
        random.setstate(state)
    got = old_case.sample_subsets(len(var), SMALL)
    assert list(got) == list(old_case.SUBSETS)
    for a, k in zip(ref, old_case.SUBSETS):
        np.testing.assert_array_equal(got[k], a)


def test_unsteady_old_matches_tpinn(unsteady):
    jpb, series = unsteady
    arrays, params = _unsteady_draws(SMALL)
    tpb, _ = old_case.from_arrays(arrays, params, series, device="cpu",
                                  sizes=SMALL)
    _same_losses(jpb, tpb)
    assert [l.name for l in tpb.losses][11:] == ["CI_u", "CI_v", "CI_p",
                                                 "COL_u", "COL_v", "COL_p"]
    assert [(l.normalization, l.weight) for l in tpb.losses[:3]] == [
        (1e0, 1e-2), (1e4, 1e-2), (1e4, 1e-2)]
    old_case.train(tpb, ITERS, "jax")
    _check(jpb.history, tpb.history)


def test_unsteady_old_group_flags(unsteady):
    """Each enable flag removes its group of losses."""
    _, series = unsteady
    arrays, params = _unsteady_draws(SMALL, use_noise=False)
    tpb, _ = old_case.from_arrays(
        arrays, params, series, device="cpu", sizes=SMALL,
        use_pdelosses=False, use_initialco=False, coll_pressure=False)
    assert [l.name for l in tpb.losses] == [
        f"BCD_{c}_{e}" for e in old_case.EDGES for c in "uv"] + [
        "COL_u", "COL_v"]
    tpb, _ = old_case.from_arrays(arrays, params, series, device="cpu",
                                  sizes=SMALL, use_boundaryc=False,
                                  coll_velocity=False)
    assert [l.name for l in tpb.losses] == [
        "PDE_MASS", "PDE_MOMU", "PDE_MOMV", "CI_u", "CI_v", "CI_p", "COL_p"]
    assert [l.name for l in tpb.losses_test] == ["u_fit", "v_fit", "p_fit"]


def test_unsteady_old_main_runs_from_a_seed(tmp_path):
    """main on the committed series (each file symlinked into
    OUT/data/UnsteadyCase): the regular-grid csv derived there, the
    history and, where matplotlib is installed, the five contour figures
    in OUT/Images; the same run again from the same seed."""
    out = str(tmp_path)
    _link_files(_UNSTEADY_DATA, os.path.join(out, "data", "UnsteadyCase"))
    pb, _ = old_case.main(epochs=2, second_round="jax", out_dir=out,
                          device="cpu", **SMALL)
    h = pb.history
    assert h.round_names == ["keras_Adam", "jax_L-BFGS"]
    assert all(np.isfinite(h.loss_global))
    assert h.loss_global[-1] < h.loss_global[0]
    assert os.path.isfile(os.path.join(
        out, "data", "UnsteadyCase",
        "navier-stokes_SI_cavity_unsteady_r.csv"))
    images = set(os.listdir(os.path.join(out, "Images")))
    assert f"{old_case.problem_name}_history_loss.json" in images
    if utils.has_module("matplotlib"):
        assert {f"{old_case.problem_name}_Graphic_{i}_of_5.jpg"
                for i in range(1, 6)} <= images
    pb2, _ = old_case.main(epochs=2, second_round="jax", out_dir=out,
                           device="cpu", save_plots=False, **SMALL)
    assert pb2.history.loss_global == h.loss_global
    with pytest.raises(ValueError, match="out_dir"):
        old_case.main(device="cpu")
