"""The port's steady cavity against the JAX package's, in float64 on the CPU:
the numpy file layer (tpinn_torch/oracles/io.py), the steady generator and
the unsteady regular-grid csv (tpinn_torch/oracles/generate.py), and the
Cavity_Steady case (tpinn_torch/cases/cavity_steady.py) against
examples/Cavity_Steady/cavity_steady.py.

* The csv reader against tpinn's pandas reader on the committed files:
  bit-equal to pandas' correctly rounded parser (``round_trip``); tpinn's
  default parser is not correctly rounded and differs from it in 5,991 of
  the 25,000 values of the random-point csv and 12,782 of the 50,000 of the
  regular-grid csv, by up to 6,023 ulp of a small value and at most 1 ulp
  of the column's largest magnitude, the bar used here.
* The csv writer writes pandas' text byte for byte.
* The generator against tpinn's at n_solver 16, t_end 0.5: the fields and
  both csv files within 1e-10·max|field|, the same CG iterations in every
  pressure solve; from cached fields it derives the random-point csv.
* Cavity_Steady: its spec, options and groups equal the example's; fed the
  example driver's data (``from_arrays``) its Adam round matches within
  1e-10 and 10 iterations of the default "scipy" round (the dense BFGS)
  within 1e-8; ``main`` runs, reloads and resumes on the committed data.
"""

import importlib.util
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from tpinn.oracles import generate as jgen
from tpinn.oracles import io as jio
from tpinn_torch import utils
from tpinn_torch.cases import cavity_steady as cs
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import StandardNSDriver
from tpinn_torch.oracles import cavity as tc
from tpinn_torch.oracles import generate as tgen
from tpinn_torch.oracles import io as tio
from tests import test_torch_lm as lm
from tests import test_torch_poisson_case as pc
from tests.test_torch_cavity_oracle import _counting_cg

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLE = os.path.join(_REPO, "examples", "Cavity_Steady")
_DATA = os.path.join(_EXAMPLE, "data", "SteadyCase")
FIELD_BAR = 1e-10
ADAM_BAR = 1e-10
ROUND_BAR = 1e-8
TINY = dict(epochs=10, noise_fit=0.01, noise_bnd=0.01, n_pde=64, n_bc=16,
            n_ic=4, n_vel=8, n_pres=1, n_test=32)
CSV_FILES = (tgen.STEADY_RANDOM_CSV, tgen.STEADY_CSV)


def _jax_example():
    path = os.path.join(_EXAMPLE, "cavity_steady.py")
    spec = importlib.util.spec_from_file_location("cavity_steady_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _link_data(folder, names=None):
    """``folder`` holding a symlink to each committed steady data file (so
    that files written there stay out of the repository)."""
    os.makedirs(folder)
    for name in names or os.listdir(_DATA):
        os.symlink(os.path.join(_DATA, name), os.path.join(folder, name))


# ---------------------------------------------------------------------------
# the file layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CSV_FILES)
def test_csv_reader_matches_tpinn_on_the_committed_files(name):
    path = os.path.join(_DATA, name)
    got = tio.read_regular_csv(path)
    ref = jio.read_regular_csv(path)
    exact = pd.read_csv(path, float_precision="round_trip")
    assert list(got) == list(ref) == ["x", "y", "ux", "uy", "p"]
    for k, a in ref.items():
        b = got[k]
        assert b.dtype == np.float64 and b.shape == a.shape
        np.testing.assert_array_equal(b, exact[k].to_numpy())
        assert np.all(np.abs(b - a) <= np.spacing(np.max(np.abs(b))))


def _columns(rng, n):
    cols = rng.normal(size=(5, n)) * 10.0 ** rng.integers(-12, 12, (5, n))
    cols[:, :6] = [[0.0, -0.0, 1e16, 1e-5, 0.1, 5e-324]] * 5
    return cols


@pytest.mark.parametrize("with_t", [False, True])
def test_csv_writer_read_back_by_both(tmp_path, with_t):
    """The port writes pandas' text byte for byte; tpinn's reader and the
    port's read it back."""
    cols = _columns(np.random.default_rng(4), 300)
    t = np.repeat([0.0, 1e-4, 2e-4], 100) if with_t else None
    path, ref_path = str(tmp_path / "a" / "f.csv"), str(tmp_path / "f.csv")
    tio.write_regular_csv(path, *cols, t=t)
    jio.write_regular_csv(ref_path, *cols, t=t)
    with open(path) as f, open(ref_path) as g:
        assert f.read() == g.read()
    names = (["t"] if with_t else []) + ["x", "y", "ux", "uy", "p"]
    want = dict(zip(names, ([t] if with_t else []) + list(cols)))
    got, ref = tio.read_regular_csv(path), jio.read_regular_csv(path)
    assert list(got) == list(ref) == names
    for k in names:
        np.testing.assert_array_equal(got[k], want[k])
        assert np.all(np.abs(ref[k] - want[k])
                      <= np.spacing(np.max(np.abs(want[k]))))


@pytest.mark.parametrize("h5", [True, False])
def test_steady_fields_and_geometry_round_trip(tmp_path, monkeypatch, h5):
    """The steady fields with the vertex coordinates, through h5 (tpinn's
    readers read the port's file and the port's tpinn's) and, without
    h5py, through an npz of the same names; the .xdmf text is tpinn's."""
    ref_path = os.path.join(_DATA, "navier-stokes_cavity_steady.h5")
    ref = jio.read_fields_h5(ref_path)
    geom = jio.read_mesh_geometry_h5(ref_path)
    np.testing.assert_array_equal(tio.read_mesh_geometry(ref_path), geom)
    for a, b in zip(tio.read_fields(ref_path), ref):
        np.testing.assert_array_equal(a, b)
    if not h5:
        monkeypatch.setattr(tio.utils, "has_module", lambda name: False)
    path = tio.write_fields(tio.steady_path(str(tmp_path), tio.fields_ext()),
                            *ref, geometry=geom)
    assert path.endswith(".h5" if h5 else ".npz")
    assert tio.find_steady_path(str(tmp_path)) == path
    np.testing.assert_array_equal(tio.read_mesh_geometry(path), geom)
    for a, b in zip(tio.read_fields(path), ref):
        np.testing.assert_array_equal(a, b)
    if h5:
        np.testing.assert_array_equal(jio.read_mesh_geometry_h5(path), geom)
        for a, b in zip(jio.read_fields_h5(path), ref):
            np.testing.assert_array_equal(a, b)
    tio.write_xdmf(str(tmp_path / "a.xdmf"), "x.h5", 10201, time=3e-4)
    jio.write_xdmf(str(tmp_path / "b.xdmf"), "x.h5", 10201, time=3e-4)
    assert (tmp_path / "a.xdmf").read_text() == (tmp_path / "b.xdmf").read_text()
    with open(os.path.join(_DATA, "navier-stokes_cavity_steady.xdmf")) as f:
        committed = f.read()
    tio.write_xdmf(str(tmp_path / "c.xdmf"), "navier-stokes_cavity_steady.h5",
                   10201)
    assert (tmp_path / "c.xdmf").read_text() == committed


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

GEN = dict(U=500.0, n_solver=16, t_end=0.5)


@pytest.fixture(scope="module")
def jax_steady(tmp_path_factory):
    """tpinn's steady files at n_solver 16 and its CG counts."""
    counts = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.scipy.sparse.linalg, "cg", _counting_cg(counts))
        jax.clear_caches()
        folder = jgen.generate_cavity_steady(
            str(tmp_path_factory.mktemp("jsteady")), **GEN)
        jax.effects_barrier()
    jax.clear_caches()
    return folder, counts


def _assert_close(ref, got):
    for a, b in zip(ref, got):
        assert a.shape == b.shape
        scale = max(float(np.max(np.abs(a))), 1e-300)
        assert float(np.max(np.abs(a - b))) <= FIELD_BAR * scale


@pytest.mark.parametrize("h5", [True, False])
def test_generate_steady_matches_tpinn(tmp_path, monkeypatch, jax_steady,
                                       h5):
    jfolder, jcounts = jax_steady
    if not h5:
        monkeypatch.setattr(tio.utils, "has_module", lambda name: False)
    counts = tc.CGCounts()
    folder = tgen.generate_cavity_steady(str(tmp_path), device="cpu",
                                         counts=counts, **GEN)
    its = counts.iterations()
    assert its == jcounts and len(its) == 50  # one block of 50 steps
    fields = tio.find_steady_path(folder)
    want = {tgen.STEADY_CSV, tgen.STEADY_RANDOM_CSV}
    want |= ({"navier-stokes_cavity_steady.h5",
              "navier-stokes_cavity_steady.xdmf"} if h5
             else {"navier-stokes_cavity_steady.npz"})
    assert set(os.listdir(folder)) == want
    jfields = os.path.join(jfolder, "navier-stokes_cavity_steady.h5")
    _assert_close(jio.read_fields_h5(jfields), tio.read_fields(fields))
    np.testing.assert_array_equal(tio.read_mesh_geometry(fields),
                                  jio.read_mesh_geometry_h5(jfields))
    for name in CSV_FILES:
        ref = tio.read_regular_csv(os.path.join(jfolder, name))
        got = tio.read_regular_csv(os.path.join(folder, name))
        assert list(got) == list(ref)
        np.testing.assert_array_equal(got["x"], ref["x"])
        np.testing.assert_array_equal(got["y"], ref["y"])
        _assert_close([ref[k] for k in ("ux", "uy", "p")],
                      [got[k] for k in ("ux", "uy", "p")])
    if h5:
        name = "navier-stokes_cavity_steady.xdmf"
        with open(os.path.join(jfolder, name)) as f, \
                open(os.path.join(folder, name)) as g:
            assert f.read() == g.read()
    # found again: kept, no solve
    again = tc.CGCounts()
    assert tgen.generate_cavity_steady(str(tmp_path), device="cpu",
                                       counts=again, **GEN) == folder
    assert again.iterations() == []


def test_cached_steady_derives_the_random_csv(tmp_path):
    """From the committed fields and regular-grid csv, without the random
    csv: no solve, and the derived csv equals the committed one (the same
    draws and interpolation; the text is byte-identical)."""
    folder = str(tmp_path / "SteadyCase")
    _link_data(folder, ["navier-stokes_cavity_steady.h5",
                        "navier-stokes_cavity_steady_r.csv"])
    counts = tc.CGCounts()
    assert tgen.generate_cavity_steady(str(tmp_path), U=500.0, n_solver=128,
                                       t_end=40.0, device="cpu",
                                       counts=counts) == folder
    assert counts.iterations() == []
    got = tio.read_regular_csv(os.path.join(folder, tgen.STEADY_RANDOM_CSV))
    ref = tio.read_regular_csv(os.path.join(_DATA, tgen.STEADY_RANDOM_CSV))
    for k in ref:
        assert np.all(np.abs(got[k] - ref[k])
                      <= np.spacing(np.max(np.abs(ref[k]))))
    with open(os.path.join(folder, tgen.STEADY_RANDOM_CSV)) as f, \
            open(os.path.join(_DATA, tgen.STEADY_RANDOM_CSV)) as g:
        assert f.read() == g.read()
    with open(os.path.join(folder, "navier-stokes_cavity_steady.xdmf")) as f, \
            open(os.path.join(_DATA, "navier-stokes_cavity_steady.xdmf")) as g:
        assert f.read() == g.read()


def _digests(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = f.read()
    return out


def test_linked_steady_data_without_h5py_is_kept(tmp_path, monkeypatch):
    """Linked data files without h5py: the linked h5 is the cache (no
    solve); with the random csv missing, deriving it raises naming h5py;
    with the regular-grid csv missing the solve writes new files in place
    of the links and leaves their targets as they were."""
    src = str(tmp_path / "src")
    shutil.copytree(_DATA, src)
    before = _digests(src)
    folder = str(tmp_path / "SteadyCase")
    os.makedirs(folder)
    for name in os.listdir(src):
        os.symlink(os.path.join(src, name), os.path.join(folder, name))
    monkeypatch.setattr(tio.utils, "has_module", lambda name: False)
    kw = dict(U=500.0, n_solver=8, t_end=0.01, device="cpu")
    solves = []
    real_solve = tc.solve_cavity_steady
    monkeypatch.setattr(tc, "solve_cavity_steady",
                        lambda **k: solves.append(k) or real_solve(**k))
    assert tgen.generate_cavity_steady(str(tmp_path), **kw) == folder
    assert solves == []
    os.remove(os.path.join(folder, tgen.STEADY_RANDOM_CSV))
    with pytest.raises(ImportError, match="h5py"):
        tgen.generate_cavity_steady(str(tmp_path), **kw)
    assert solves == []
    os.symlink(os.path.join(src, tgen.STEADY_RANDOM_CSV),
               os.path.join(folder, tgen.STEADY_RANDOM_CSV))
    os.remove(os.path.join(folder, tgen.STEADY_CSV))
    tgen.generate_cavity_steady(str(tmp_path), **kw)
    assert len(solves) == 1
    for name in CSV_FILES:
        assert not os.path.islink(os.path.join(folder, name))
    assert os.path.exists(os.path.join(folder,
                                       "navier-stokes_cavity_steady.npz"))
    assert _digests(src) == before


def test_unsteady_regular_csv_and_xdmf(tmp_path, monkeypatch):
    """The unsteady series' regular-grid csv with its t column and the
    per-step .xdmf wrappers, against tpinn's, for a fresh series and
    derived again from the cached one; without h5py the series is npz and
    no wrapper is written."""
    kw = dict(U=1.0, nu=1.0, T=3e-4, dt=1e-4, n=12)
    jfolder = jgen.generate_cavity_unsteady(str(tmp_path / "j"), **kw)
    folder = tgen.generate_cavity_unsteady(str(tmp_path / "t"), device="cpu",
                                           **kw)
    csv = os.path.join(folder, tgen.UNSTEADY_CSV)
    ref = tio.read_regular_csv(os.path.join(jfolder, tgen.UNSTEADY_CSV))
    got = tio.read_regular_csv(csv)
    assert list(got) == list(ref) == ["t", "x", "y", "ux", "uy", "p"]
    assert got["t"].shape == (30_000,)
    for k in ("t", "x", "y"):
        np.testing.assert_array_equal(got[k], ref[k])
    _assert_close([ref[k] for k in ("ux", "uy", "p")],
                  [got[k] for k in ("ux", "uy", "p")])
    for it in range(3):
        name = f"navier-stokes_SI_cavity_unsteady_{it:05d}.xdmf"
        with open(os.path.join(jfolder, name)) as f, \
                open(os.path.join(folder, name)) as g:
            assert f.read() == g.read()
    with open(csv) as f:
        fresh = f.read()
    os.remove(csv)
    os.remove(os.path.join(folder, "navier-stokes_SI_cavity_unsteady_00001.xdmf"))
    assert tgen.generate_cavity_unsteady(str(tmp_path / "t"), device="cpu",
                                         **kw) == folder
    with open(csv) as f:
        assert f.read() == fresh
    assert os.path.exists(os.path.join(
        folder, "navier-stokes_SI_cavity_unsteady_00001.xdmf"))
    monkeypatch.setattr(tio.utils, "has_module", lambda name: False)
    npz = tgen.generate_cavity_unsteady(str(tmp_path / "n"), device="cpu",
                                        **kw)
    assert set(os.listdir(npz)) == {tgen.UNSTEADY_CSV} | {
        f"navier-stokes_SI_cavity_unsteady_{it:05d}.npz" for it in range(3)}
    with open(os.path.join(npz, tgen.UNSTEADY_CSV)) as f:
        assert f.read() == fresh


def test_generate_cli(tmp_path, capsys):
    """``python -m tpinn_torch.oracles.generate --case steady`` at a small
    solver grid writes the steady folder."""
    tgen.main(["--case", "steady", "--out", str(tmp_path), "--n-solver", "8",
               "--device", "cpu"])
    assert str(tmp_path / "SteadyCase") in capsys.readouterr().out
    assert set(os.listdir(tmp_path / "SteadyCase")) >= set(CSV_FILES)
    u, v, p = tio.read_fields(tio.find_steady_path(str(tmp_path / "SteadyCase")))
    assert u.shape == (101 ** 2,) and abs(np.max(u) - 500.0) < 1e-9
    assert all(np.isfinite(a).all() for a in (u, v, p))


# ---------------------------------------------------------------------------
# the case
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exact():
    """The committed fields through the example's loader and the port's."""
    jex = _jax_example()
    return jex, jex.load_exact(os.path.join(_EXAMPLE, "data")), cs.load_exact(
        os.path.join(_EXAMPLE, "data"), device="cpu")


def test_spec_options_and_groups_match_the_example(exact):
    jex, ref_data, data = exact
    for a, b in zip(ref_data, data):
        np.testing.assert_array_equal(b, a)
    ref, got = jex.build_spec(ref_data), cs.build_spec(data)
    for f in ("name", "grid_shape", "bnd_val", "neumann", "weights",
              "unsteady", "width", "depth", "pressure_gauge", "uniform_mesh"):
        assert getattr(got, f) == getattr(ref, f), f
    assert [tuple(e) for e in got.extents] == [tuple(e) for e in ref.extents]
    for f in ("conv", "visc", "time", "pres"):
        assert getattr(got.physics, f) == getattr(ref.physics, f)
    assert cs.default_options().__dict__ == jex.default_options().__dict__
    assert cs.LOSS_GROUPS == jex.LOSS_GROUPS
    assert cs.U_LID == jex.U_LID
    # the contour grids come from the regular-grid csv, as in the example
    gu, gv, gp = cs.exact_grids(os.path.join(_EXAMPLE, "data"))
    csv = jio.read_regular_csv(os.path.join(_DATA, tgen.STEADY_CSV))
    ref_u = csv["ux"].reshape(100, 100)
    assert np.all(np.abs(gu - ref_u) <= np.spacing(np.max(np.abs(ref_u))))
    np.testing.assert_allclose(gp.mean(), 0.0, atol=1e-9)


def test_tiny_rounds_match_the_example(tmp_path, exact):
    from tpinn.config import SimulationOptions as JaxOptions
    from tpinn.driver import StandardNSDriver as JaxDriver

    jex, ref_data, data = exact
    jd = JaxDriver(jex.build_spec(ref_data), JaxOptions(**TINY),
                   base_dir=str(tmp_path), save_results=False, seed=0,
                   adam_epochs=20)
    arrays = lm._arrays(jd)
    td = StandardNSDriver.from_arrays(
        cs.build_spec(data), SimulationOptions(**TINY),
        base_dir=str(tmp_path), save_results=False, seed=0, device="cpu",
        adam_epochs=20, **arrays)
    assert td.second_round == "scipy"
    assert td.dom_grid.shape == (101 ** 2, 2)
    assert [l.name for l in td.losses][-3:] == ["Fit_u", "Fit_v", "Fit_p"]
    assert (td.norm.norm_vel, td.norm.norm_pre) == (jd.norm.norm_vel,
                                                    jd.norm.norm_pre)
    hj = jd.train(callbacks=False).history
    ht = td.train(callbacks=False).history
    assert ht.round_names == hj.round_names == ["keras_Adam", "jax_BFGS"]
    assert ht.iters == hj.iters
    assert list(ht.losses) == list(hj.losses)
    assert pc._rel_devs(hj, ht, {1}) < ADAM_BAR
    assert pc._rel_devs(hj, ht, {2}) < ROUND_BAR
    assert ht.loss_global[-1] < ht.loss_global[0]


def _options_file(folder):
    SimulationOptions(**{**TINY, "epochs": 3}).to_file(
        os.path.join(folder, "simulation_options.txt"))


def test_main_runs_loads_and_resumes(tmp_path):
    """main on the committed data (symlinked into BASE/data/SteadyCase):
    Adam and the default "scipy" round, the run folder; a ``load_from``
    reload skips training and gives the same model and test losses; a
    ``resume_from`` run appends a second BFGS round."""
    base = str(tmp_path)
    _link_data(os.path.join(base, "data", "SteadyCase"))
    _options_file(base)
    drv = cs.main(base_dir=base, device="cpu")
    h = drv.pb.history
    assert h.round_names == ["keras_Adam", "jax_BFGS"]
    assert drv.opts.n_pde == TINY["n_pde"] and drv.opts.epochs == 3
    files = set(os.listdir(drv.folder))
    assert {"Model.json", "History_Loss.json", "checkpoint.pkl",
            "Test_Options.txt"} <= files
    if utils.has_module("matplotlib"):
        assert {"Graphic.jpg", "Loss_Trend_Reduced.png"} <= files
    tests = {name: float(l.raw_value().detach()) for name, l in
             zip(h.losses_test, drv.losses_test)}
    loaded = cs.main(base_dir=base, device="cpu", load_from=drv.folder)
    assert loaded.pb.history.loss_global == h.loss_global
    assert loaded.final_test_losses() == drv.final_test_losses()
    assert {name: float(l.raw_value().detach()) for name, l in
            zip(h.losses_test, loaded.losses_test)} == tests
    x = drv.dom_grid[:50]
    with torch.no_grad():
        assert torch.equal(loaded.model(x), drv.model(x))
    resumed = cs.main(base_dir=base, device="cpu", epochs=2,
                      resume_from=drv.folder)
    assert resumed.pb.history.round_names == ["keras_Adam", "jax_BFGS",
                                              "jax_BFGS"]
    assert resumed.pb.history.loss_global[-1] <= h.loss_global[-1]
    shutil.rmtree(os.path.join(base, "data"))
