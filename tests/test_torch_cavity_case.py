"""The port's Cavity_Unsteady case (tpinn_torch/cases/cavity_unsteady.py)
against the JAX package's example (examples/Cavity_Unsteady/
cavity_unsteady.py), on the committed exact data (the JAX oracle's per-step
h5 series, which this host's h5py reads).

* ``build_spec``, ``default_options`` and ``LOSS_GROUPS`` equal the
  example's;
* both readers give the same concatenated series;
* at tiny options the port's driver, fed the example driver's grid, splits,
  boundary, t = 0 and fit points and initial θ (``from_arrays``), logs the
  same Adam round within 1e-10 (the 3-32-32-32-3 net, the full 1.02 M-point
  space-time grid);
* ``main`` runs end to end on the CPU (Adam, the default "scipy" round, the
  artifacts with the time-slice figures), resumes, and takes
  ``--pde-weights``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from tpinn.oracles import io as jio
from tpinn_torch.cases import cavity_unsteady as cu
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import StandardNSDriver
from tpinn_torch.history import History
from tpinn_torch.oracles import io as tio

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLE = os.path.join(_REPO, "examples", "Cavity_Unsteady")
_DATA = os.path.join(_EXAMPLE, "data", "UnsteadyCase")
HISTORY_BAR = 1e-10
TINY = dict(epochs=2, noise_fit=0.05, noise_bnd=0.05, n_pde=64, n_bc=16,
            n_ic=16, n_vel=8, n_pres=0, n_test=32)


def _jax_example():
    path = os.path.join(_EXAMPLE, "cavity_unsteady.py")
    spec = importlib.util.spec_from_file_location("cavity_unsteady_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def series():
    """The committed series through tpinn's reader and the port's."""
    return (jio.read_unsteady_series_h5(_DATA, 100),
            tio.read_unsteady_series(_DATA, 100))


def test_readers_agree_on_the_committed_series(series):
    ref, got = series
    for a, b in zip(ref, got):
        assert a.shape == (100 * 101 ** 2,)
        np.testing.assert_array_equal(b, a)


def test_spec_options_and_groups_match_the_example(series):
    jex = _jax_example()
    ref, got = jex.build_spec(series[0]), cu.build_spec(series[1])
    for f in ("name", "grid_shape", "bnd_val", "neumann", "weights",
              "unsteady", "time_horizon", "dt", "width", "depth",
              "pressure_gauge", "uniform_mesh"):
        assert getattr(got, f) == getattr(ref, f), f
    assert [tuple(e) for e in got.extents] == [tuple(e) for e in ref.extents]
    for f in ("conv", "visc", "time", "pres"):
        assert getattr(got.physics, f) == getattr(ref.physics, f)
    assert got.dim_in == ref.dim_in == 3
    assert cu.default_options().__dict__ == jex.default_options().__dict__
    assert cu.LOSS_GROUPS == jex.LOSS_GROUPS
    assert (cu.T_HORIZON, cu.DT) == (jex.T_HORIZON, jex.DT)


def test_tiny_adam_round_matches_the_example(tmp_path, series):
    from tpinn.config import SimulationOptions as JaxOptions
    from tpinn.driver import StandardNSDriver as JaxDriver

    jex = _jax_example()
    jd = JaxDriver(jex.build_spec(series[0]), JaxOptions(**TINY),
                   base_dir=str(tmp_path), save_results=False, seed=0,
                   second_round="none", adam_epochs=10)
    arrays = dict(
        dom_grid=np.asarray(jd.dom_grid), idx_set=jd.idx_set,
        bnd_pts={k: np.asarray(v) for k, v in jd.bnd_pts.items()},
        bnd_val_num={c: {e: np.asarray(v) for e, v in d.items()}
                     for c, d in jd.bnd_val_num.items()},
        sol_noise=[np.asarray(a) for a in jd.sol_noise],
        ic_pts=np.asarray(jd.ic_pts),
        params=[{k: np.asarray(p[k]) for k in ("kernel", "bias")}
                for p in jd.model.params])
    td = StandardNSDriver.from_arrays(
        cu.build_spec(series[1]), SimulationOptions(**TINY),
        base_dir=str(tmp_path), save_results=False, seed=0, device="cpu",
        second_round="none", adam_epochs=10, **arrays)
    assert td.dom_grid.shape == (1_020_100, 3)
    assert (td.norm.norm_vel, td.norm.norm_pre) == (jd.norm.norm_vel,
                                                    jd.norm.norm_pre)
    hj = jd.train(callbacks=False).history
    h = td.train(callbacks=False).history
    assert h.iters == hj.iters == [0, 10]
    assert list(h.losses) == list(hj.losses)
    devs = [np.max(np.abs(np.array(h.loss_global) - hj.loss_global)
                   / np.abs(hj.loss_global))]
    for group in ("losses", "losses_test"):
        for name, entry in getattr(hj, group).items():
            a = np.array(entry["log"])
            b = np.array(getattr(h, group)[name]["log"])
            devs.append(np.max(np.abs(b - a) / np.abs(a)))
    assert max(devs) < HISTORY_BAR


def _options_file(folder, **kw):
    """simulation_options.txt in the legacy every-other-line format."""
    o = {**TINY, **kw}
    names = ("TRAINING EPOCHS", "NOISE ON FITTING", "NOISE ON BOUNDARY",
             "POINTS PDE", "POINTS BOUNDARY CONDITIONS",
             "POINTS INITIAL CONDITIONS", "POINTS VELOCITY FITTING",
             "POINTS PRESSURE FITTING", "POINT TEST EVALUATION")
    keys = ("epochs", "noise_fit", "noise_bnd", "n_pde", "n_bc", "n_ic",
            "n_vel", "n_pres", "n_test")
    lines = ["### options ###"]
    for name, key in zip(names, keys):
        lines += [name, str(o[key])]
    (folder / "simulation_options.txt").write_text(
        "\n".join(lines + ["### End of the File ###"]) + "\n")


def test_main_runs_resumes_and_takes_pde_weights(tmp_path, series):
    base = tmp_path / "run"
    base.mkdir()
    _options_file(base)
    drv = cu.main(epochs=2, base_dir=str(base), device="cpu", adam_epochs=3,
                  exact_data=series[1])
    assert drv.opts.__dict__ == SimulationOptions(**TINY).__dict__
    h = drv.pb.history
    assert h.round_names == ["keras_Adam", "jax_BFGS"]
    assert [l.name for l in drv.losses][-5:] == ["IC_u", "IC_v", "IC_p",
                                                 "Fit_u", "Fit_v"]
    files = set(os.listdir(drv.folder))
    assert {"Model.json", "History_Loss.json", "checkpoint.pkl",
            "Test_Options.txt", "Loss_Trend_Reduced.png"} <= files
    assert {f"Graphic_{i}_of_5.jpg" for i in range(1, 6)} <= files
    again = cu.main(epochs=2, base_dir=str(base), device="cpu",
                    exact_data=series[1], resume_from=drv.folder)
    hr = History.load(os.path.join(drv.folder, "History_Loss.json"))
    assert hr.round_names == ["keras_Adam", "jax_BFGS", "jax_BFGS"]
    assert again.pb.history.loss_global[-1] <= h.loss_global[-1]
    weighted = cu.main(epochs=0, base_dir=str(base), device="cpu",
                       adam_epochs=1, exact_data=series[1],
                       pde_weights="1e2,1e1,1e1", second_round="none")
    assert [l.weight for l in weighted.losses[:3]] == [1e2, 1e1, 1e1]


def test_main_reads_the_data_folder(tmp_path):
    """Without exact_data, main reads BASE/data/UnsteadyCase (the oracle
    runs only when the series is missing; the regular-grid csv is derived
    from the series found there) and the options file."""
    base = tmp_path / "case"
    # each file linked, so that the regular-grid csv the generator derives
    # from the series is written here
    os.makedirs(base / "data" / "UnsteadyCase")
    for name in os.listdir(_DATA):
        os.symlink(os.path.join(_DATA, name),
                   base / "data" / "UnsteadyCase" / name)
    _options_file(base, epochs=0, n_pde=32, n_bc=8, n_ic=8, n_vel=4,
                  n_test=16)
    drv = cu.main(base_dir=str(base), device="cpu", adam_epochs=1,
                  second_round="none", save_results=False)
    assert drv.opts.n_pde == 32 and drv.opts.n_ic == 8
    assert drv.dom_grid.shape == (1_020_100, 3)
    assert os.path.basename(drv.folder) == "Last_Training"
    assert os.path.isfile(base / "data" / "UnsteadyCase"
                          / "navier-stokes_SI_cavity_unsteady_r.csv")
