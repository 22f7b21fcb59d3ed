"""The port's coronary case (tpinn_torch/cases/coronary_flow_steady.py)
against the JAX package's example (examples/Coronary_Flow/
coronary_flow_steady.py), on the committed mesh, boundary points and
SteadyCase fields copied into a base dir with smaller options (300 PDE,
20 fit and 200 test points; the widths stay 2-32-32-32-3):

* from tpinn's θ0, index sets and noise (its ``PRNGKey`` draws, passed
  through numpy) the port logs the same rounds: Adam 100 at 1e-10, the
  default "scipy" route (dense BFGS) 10 iterations at 1e-8, LM 3
  iterations at 1e-8, and Adam with boundary noise at 1e-10;
* the LM round through kernel 5's plain version (``TPINN_USE_PALLAS=1``)
  equals the closed-form bundle at 1e-12, with three bundle evaluations
  per residual evaluation;
* run #005's trained weights (Weights.h5) reproduce its ``sol_pinn.h5`` on
  every node with the refine-1 normalization at 1e-11·max|field|;
* ``main`` writes the run folder and ``--resume`` continues it; a fresh
  interpreter without h5py and matplotlib runs the case's CLI on npz data.
"""

import contextlib
import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpinn.config import SimulationOptions as JaxOptions
from tpinn.geometry import generate_noise as jax_noise
from tpinn.geometry import split_indices as jax_split
from tpinn.models import MLP as JaxMLP
from tpinn.oracles import io as jio
from tpinn_torch.cases import coronary_flow_steady as cfs
from tpinn_torch.config import SimulationOptions
from tpinn_torch.history import History
from tpinn_torch.kernels import mlp_bundle
from tpinn_torch.optimize import minimize
from tpinn_torch.optimizers import Adam
from tpinn_torch.oracles import io as tio

torch.set_num_threads(1)

try:
    from threadpoolctl import threadpool_limits as blas_threads
except ImportError:  # without threadpoolctl the threads stay as they are
    def blas_threads(limit):
        return contextlib.nullcontext()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLE = os.path.join(_REPO, "examples", "Coronary_Flow")
ADAM_BAR = 1e-10
ROUND_BAR = 1e-8
OPTIONS = dict(epochs=10, noise_fit=0.01, noise_bnd=0.0, n_pde=300,
               n_bc=800, n_ic=0, n_vel=20, n_pres=0, n_test=200)


def _jax_example():
    path = os.path.join(_EXAMPLE, "coronary_flow_steady.py")
    spec = importlib.util.spec_from_file_location("coronary_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _base_dir(path, **overrides):
    """A base dir holding the committed mesh, boundary points and
    SteadyCase data and a small simulation_options.txt."""
    os.makedirs(os.path.join(path, "data"))
    shutil.copytree(os.path.join(_EXAMPLE, "data", "SteadyCase"),
                    os.path.join(path, "data", "SteadyCase"))
    for name in ("coroParam.msh", "bpoints.npy"):
        shutil.copy(os.path.join(_EXAMPLE, name), path)
    SimulationOptions(**{**OPTIONS, **overrides}).to_file(
        os.path.join(path, "simulation_options.txt"))
    return str(path)


def _jax_arrays(base, seed=0):
    """The example's data and draws (index sets, fit and boundary noise)
    and its θ0, exactly as its ``main`` makes them, as numpy."""
    opts = JaxOptions.from_file(os.path.join(base, "simulation_options.txt"))
    data = cfs.load_data(base)
    key = jax.random.PRNGKey(seed)
    k_split, k_noise = jax.random.split(key)
    idx = {k: np.asarray(v) for k, v in
           jax_split(k_split, len(data["nodes"]), opts.n_pts).items()}
    kf = jax.random.split(k_noise, 2)
    fit_noise = [np.asarray(jax_noise(kf[i], len(idx["Vel"]), opts.noise_fit))
                 for i in (0, 1)]
    bnd_noise = {}
    if opts.noise_bnd:
        kb = jax.random.split(jax.random.fold_in(k_noise, 1), 4)
        for ki, (comp, grp) in enumerate(cfs.NOISY_GROUPS):
            bnd_noise[(comp, grp)] = np.asarray(jax_noise(
                kb[ki], len(data["bnd"][grp]), opts.noise_bnd))
    dg = data["nodes"]
    jm = JaxMLP(2, 3, width=32, depth=3, seed=seed,
                input_extents=[(dg[:, 0].min(), dg[:, 0].max()),
                               (dg[:, 1].min(), dg[:, 1].max())])
    params = [{k: np.asarray(p[k]) for k in ("kernel", "bias")}
              for p in jm.params]
    arrays = {**data, "idx": idx, "fit_noise": fit_noise,
              "bnd_noise": bnd_noise}
    return arrays, params, opts


def _port_problem(arrays, params):
    model = cfs.make_model("cpu", params=params)
    pb, norm = cfs.build(model, arrays)
    return pb, model


def _rel_devs(h_ref, h, sel):
    series = [(h_ref.loss_global, h.loss_global)]
    for group in ("losses", "losses_test"):
        ref, got = getattr(h_ref, group), getattr(h, group)
        assert list(got) == list(ref)
        series += [(ref[k]["log"], got[k]["log"]) for k in ref]
    return max(float(np.max(np.abs(np.array(b)[sel] - np.array(a)[sel])
                            / np.abs(np.array(a)[sel]))) for a, b in series)


def _check_rounds(jpb, tpb, rounds, second_bar):
    hj, ht = jpb.history, tpb.history
    assert ht.round_names == hj.round_names == rounds
    assert ht.iters == hj.iters and ht.round_starts == hj.round_starts
    adam = [i for i, r in enumerate(hj.rounds_idx) if r == 1]
    assert _rel_devs(hj, ht, adam) < ADAM_BAR
    if len(rounds) > 1:
        assert _rel_devs(hj, ht, list(range(len(hj.iters)))) < second_bar
    for name, entry in hj.losses.items():
        assert ht.losses[name]["weight"] == entry["weight"]


@pytest.fixture(scope="module")
def jax_example():
    return _jax_example()


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """numpy's BLAS on one thread, as torch here: the suite runs several
    workers, and a 2,307² ``eigh`` spinning on every core of each of them
    slows every file."""
    with blas_threads(1):
        yield


def test_losses_options_and_groups_match_the_example(tmp_path, jax_example):
    base = _base_dir(tmp_path / "b")
    arrays, params, _ = _jax_arrays(base)
    pb, model = _port_problem(arrays, params)
    assert [l.name for l in pb.losses] == [
        "PDE_MASS", "PDE_MOMU", "PDE_MOMV", "BCD_u_NS", "BCD_v_NS",
        "BCD_u_IN", "BCD_v_IN", "BCN_u_OUT1", "BCN_v_OUT1", "BCN_u_OUT2",
        "BCN_v_OUT2", "Fit_u", "Fit_v"]
    assert [l.weight for l in pb.losses] == [1e2, 1e1, 1e1] + [1.0] * 4 \
        + [1e-3] * 4 + [1.0] * 2
    assert all(l.point_residual is not None for l in pb.losses)
    assert [l.name for l in pb.losses_test] == ["u_test", "v_test", "p_test"]
    assert cfs.LOSS_GROUPS == jax_example.LOSS_GROUPS
    assert cfs.default_options().__dict__ == \
        jax_example.default_options().__dict__
    assert vars(cfs.PRM) == vars(jax_example.PRM)
    assert cfs.PRM.ni == jax_example.PRM.ni
    assert model.layer_sizes == (2, 32, 32, 32, 3)


def test_adam_and_dense_bfgs_match_the_example(tmp_path, jax_example):
    """The default route ("scipy": the on-device dense BFGS) for 10
    iterations after Adam 100."""
    base = _base_dir(tmp_path / "b")
    jpb, _ = jax_example.main(10, base_dir=base, second_round="scipy")
    arrays, params, _ = _jax_arrays(base)
    tpb, _ = _port_problem(arrays, params)
    cfs.train(tpb, "scipy", 10)
    _check_rounds(jpb, tpb, ["keras_Adam", "jax_BFGS"], ROUND_BAR)
    assert tpb.history.iter_round[-1] == 10


def test_lm_round_matches_the_example(tmp_path, jax_example):
    base = _base_dir(tmp_path / "b")
    jpb, _ = jax_example.main(3, base_dir=base, second_round="lm")
    arrays, params, _ = _jax_arrays(base)
    tpb, _ = _port_problem(arrays, params)
    cfs.train(tpb, "lm", 3)
    _check_rounds(jpb, tpb, ["keras_Adam", "jax_LM"], ROUND_BAR)
    h = tpb.history
    assert h.iter_round[-1] == 3
    assert h.loss_global[-1] < h.loss_global[h.rounds_idx.index(2)]


def test_boundary_noise_path_matches_the_example(tmp_path, jax_example):
    base = _base_dir(tmp_path / "b", noise_bnd=0.01)
    jpb, _ = jax_example.main(0, base_dir=base, second_round="none")
    arrays, params, opts = _jax_arrays(base)
    assert opts.noise_bnd == 0.01 and len(arrays["bnd_noise"]) == 4
    tpb, _ = _port_problem(arrays, params)
    cfs.train(tpb, "none", 0)
    _check_rounds(jpb, tpb, ["keras_Adam"], ROUND_BAR)


def test_lm_through_kernel_5_plain_equals_closed_form(tmp_path, monkeypatch):
    """Under ``TPINN_USE_PALLAS=1`` the three bundles (PDE, OUT1, OUT2) come
    from kernel 5's wrapper (its plain version on the CPU), once each per
    residual evaluation; the LM round equals the closed form's at 1e-12."""
    base = _base_dir(tmp_path / "b")
    arrays, params, _ = _jax_arrays(base)
    off, _ = _port_problem(arrays, params)
    minimize(off, "keras", Adam(learning_rate=1e-2), num_epochs=10)
    theta = off.get_vector()
    monkeypatch.setenv("TPINN_USE_PALLAS", "1")
    on, _ = _port_problem(arrays, params)
    on.set_vector(theta)
    calls, evaluations = [], []
    real_bundle = mlp_bundle.mlp_taylor_bundle
    monkeypatch.setattr(mlp_bundle, "mlp_taylor_bundle",
                        lambda *a, **k: calls.append(a[1].shape[0])
                        or real_bundle(*a, **k))
    for name in ("residuals_at", "eval_all"):
        real = getattr(on, name)
        setattr(on, name, (lambda real: lambda *a: evaluations.append(1)
                           or real(*a))(real))
    minimize(on, "jax", "LM", num_epochs=3)
    monkeypatch.delenv("TPINN_USE_PALLAS")
    off.history = History()
    off.history.register_losses(off.losses, off.losses_test)
    minimize(off, "jax", "LM", num_epochs=3)
    assert len(calls) == 3 * len(evaluations) > 0
    assert sorted(set(calls)) == [33, 300]
    h_on, h_off = on.history, off.history
    assert h_on.iters == h_off.iters
    assert _rel_devs(h_off, h_on, list(range(len(h_on.iters)))) < 1e-12


def test_run_005_weights_reproduce_its_solution():
    """#005 trained on the refine-1 data: its weights, on every node,
    scaled by that data's normalization, give its sol_pinn.h5."""
    run = os.path.join(_EXAMPLE, "Test_Case_#005")
    h5 = os.path.join(_EXAMPLE, "data", "SteadyCase_r1",
                      "steady_coronary_steady.h5")
    nodes = tio.read_mesh_geometry(h5)
    model = cfs.make_model("cpu", input_extents=cfs.extents(nodes))
    model.load_weights(os.path.join(run, "Weights.h5"))
    u, v, p = tio.read_fields(h5)
    from tpinn_torch.geometry import Normalization

    norm = Normalization(u, v, p)
    with torch.no_grad():
        out = model(torch.as_tensor(nodes)).numpy()
    import h5py

    with h5py.File(os.path.join(run, "sol_pinn.h5"), "r") as f:
        ref = [np.asarray(f[name]) for name in cfs.SOL_NAMES]
    scales = (norm.norm_vel, norm.norm_vel, norm.norm_pre)
    for c in range(3):
        got = out[:, c] * scales[c]
        assert np.max(np.abs(got - ref[c])) <= 1e-11 * np.max(np.abs(ref[c]))


def test_main_writes_the_run_folder_and_resumes(tmp_path):
    base = _base_dir(tmp_path / "b", n_pde=100, n_vel=10, n_test=50)
    pb, model = cfs.main(3, base_dir=base, second_round="jax-bfgs",
                         device="cpu")
    folder = os.path.join(base, "Test_Case_#001")
    files = set(os.listdir(folder))
    assert {"Model.json", "History_Loss.json", "checkpoint.pkl",
            "Test_Options.txt"} <= files
    assert {"Weights.h5", "Weights.npz"} & files
    assert {"sol_pinn.h5", "sol_pinn.npz"} & files
    sol = os.path.join(folder, next(f for f in files
                                    if f.startswith("sol_pinn")))
    if sol.endswith(".h5"):
        import h5py

        with h5py.File(sol, "r") as f:
            assert sorted(f) == sorted(cfs.SOL_NAMES)
            u_pinn = np.asarray(f["u_pinn"])
    else:
        with np.load(sol) as f:
            assert sorted(f.files) == sorted(cfs.SOL_NAMES)
            u_pinn = f["u_pinn"]
    assert u_pinn.shape == (10833,) and np.isfinite(u_pinn).all()
    h = pb.history
    assert h.round_names == ["keras_Adam", "jax_BFGS"]
    # --resume: no Adam, the BFGS carry adopted, a second round appended
    pb2, _ = cfs.main(2, base_dir=base, second_round="jax-bfgs",
                      resume_from=folder, device="cpu")
    h2 = pb2.history
    assert h2.round_names == ["keras_Adam", "jax_BFGS", "jax_BFGS"]
    assert h2.loss_global[:len(h.loss_global)] == h.loss_global
    assert h2.loss_global[len(h.loss_global)] == h.loss_global[-1]
    assert os.listdir(base).count("Test_Case_#002") == 0
    assert History.load(os.path.join(folder, "History_Loss.json")) \
        .round_names == h2.round_names


def test_cli_runs_without_h5py_and_matplotlib(tmp_path):
    """A fresh interpreter in which h5py and matplotlib cannot be imported
    (as on the card's host) runs the case's CLI on npz data, an LM resume
    included, and writes npz artifacts and no figures."""
    base = tmp_path / "b"
    os.makedirs(base / "data" / "SteadyCase")
    h5 = os.path.join(_EXAMPLE, "data", "SteadyCase",
                      "steady_coronary_steady.h5")
    tio.write_fields(str(base / "data" / "SteadyCase"
                         / "steady_coronary_steady.npz"),
                     *jio.read_fields_h5(h5),
                     geometry=jio.read_mesh_geometry_h5(h5))
    shutil.copy(os.path.join(_EXAMPLE, "bpoints.npy"),
                base / "data" / "SteadyCase")
    SimulationOptions(**{**OPTIONS, "n_pde": 100, "n_vel": 10,
                         "n_test": 50}).to_file(
        str(base / "simulation_options.txt"))
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import runpy\n"
        "sys.argv = ['coronary_flow_steady'] + sys.argv[1:]\n"
        "runpy.run_module('tpinn_torch.cases.coronary_flow_steady',\n"
        "                 run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('h5py', 'matplotlib', 'jax', 'tpinn')\n"
        "       and sys.modules[m] is not None]\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # one thread each, as this file's own process runs
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    folder = str(base / "Test_Case_#001")
    for extra in (["--epochs", "2"],
                  ["--epochs", "1", "--second-round", "lm", "--resume",
                   folder]):
        proc = subprocess.run(
            [sys.executable, "-c", code, "--base-dir", str(base),
             "--device", "cpu"] + extra, cwd=_REPO, env=env,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    files = sorted(os.listdir(folder))
    assert files == ["History_Loss.json", "Model.json", "Test_Options.txt",
                     "Weights.npz", "checkpoint.pkl", "sol_pinn.npz"]
    assert History.load(os.path.join(folder, "History_Loss.json")) \
        .round_names == ["keras_Adam", "jax_BFGS", "jax_LM"]
    # the packaged mesh and boundary points were taken
    assert sorted(os.listdir(base)) == ["Test_Case_#001", "bpoints.npy",
                                        "coroParam.msh", "data",
                                        "simulation_options.txt"]
