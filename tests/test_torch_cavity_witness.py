"""The witness of Cavity_Unsteady's miss: the JAX package's own draws of
the reference run, committed for the port's card runs.

The JAX example's driver (examples/Cavity_Unsteady/cavity_unsteady.py) at
seed 0 on the committed series with the options of its
``simulation_options.txt`` (10,000 PDE points, 1,000 per edge and at t = 0,
50 fit points, 5 % noise) draws the grid splits, the boundary points and
values, the t = 0 points, the noisy fit targets and θ0.  In float32, as on
the TPU that trained the reference row, those draws and the exact u, v, p
at the Test indices go to ``docs/torch_runs/cavity_unsteady/witness/
tpinn_draws_seed0.npz``; ``tpinn_torch.witness`` trains the port from them
(``StandardNSDriver.from_arrays``).  Written by::

    PYTHONPATH= JAX_PLATFORMS=cpu JAX_ENABLE_X64=0 \\
        python tests/test_torch_cavity_witness.py --out FILE

* the committed file equals a fresh draw bit for bit (a subprocess in
  float32, the process of the tests being float64);
* the port's space-time grid equals the JAX driver's row for row, so the
  draws' indices mean the same points in both packages;
* the port's driver built from the file holds the draws it was given, and
  its evaluation at θ0 equals the JAX driver's at 1e-10 in float64 on the
  same draws (the full options, d_in 3);
* ``witness.run`` from the file, its stages cut to 2 + 2 + 2, in float32.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLE = os.path.join(_REPO, "examples", "Cavity_Unsteady")
_SERIES = os.path.join(_EXAMPLE, "data", "UnsteadyCase")
WITNESS = os.path.join(_REPO, "docs", "torch_runs", "cavity_unsteady",
                       "witness", "tpinn_draws_seed0.npz")
EVAL_BAR = 1e-10

torch.set_num_threads(1)


def series_dir(data):
    """``data/UnsteadyCase`` with the committed series linked file by file
    (a file the generator writes lands here, not in ``examples/``) and an
    empty regular-grid csv, which nothing here reads, standing in for the
    110 MB one the generator would derive."""
    from tpinn_torch.oracles.generate import UNSTEADY_CSV

    folder = data / "UnsteadyCase"
    folder.mkdir(parents=True)
    for name in os.listdir(_SERIES):
        if name.endswith((".h5", ".xdmf")):
            os.symlink(os.path.join(_SERIES, name), folder / name)
    (folder / UNSTEADY_CSV).touch()
    return data


def _jax_example():
    import importlib.util

    path = os.path.join(_EXAMPLE, "cavity_unsteady.py")
    spec = importlib.util.spec_from_file_location("cavity_unsteady_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_driver(seed=0):
    """The JAX example's driver at the committed options and series (read
    as its ``load_exact`` reads it, without the regular-grid csv that the
    generator would write beside the series)."""
    from tpinn.config import SimulationOptions
    from tpinn.driver import StandardNSDriver
    from tpinn.oracles import io as jio

    jex = _jax_example()
    exact = jio.read_unsteady_series_h5(_SERIES,
                                        int(round(jex.T_HORIZON / jex.DT)))
    opts = SimulationOptions.from_file(
        os.path.join(_EXAMPLE, "simulation_options.txt"))
    drv = StandardNSDriver(jex.build_spec(exact), opts, base_dir=_EXAMPLE,
                           save_results=False, seed=seed,
                           second_round="jax-bfgs")
    return drv, exact


def draws(drv, exact) -> dict:
    """The driver's draws as flat numpy arrays (the npz's names)."""
    out = {f"idx_{k}": np.asarray(v) for k, v in drv.idx_set.items()}
    out.update({f"bnd_pts_{k}": np.asarray(v)
                for k, v in drv.bnd_pts.items()})
    for c, d in drv.bnd_val_num.items():
        out.update({f"bnd_val_{c}_{e}": np.asarray(v) for e, v in d.items()})
    out.update({f"sol_noise_{c}": np.asarray(a)
                for c, a in enumerate(drv.sol_noise)})
    out["ic_pts"] = np.asarray(drv.ic_pts)
    for i, p in enumerate(drv.model.params):
        for k in ("kernel", "bias"):
            out[f"param_{i}_{k}"] = np.asarray(p[k])
    test = np.asarray(drv.idx_set["Test"])
    for c, name in enumerate(("u", "v", "p")):
        out[f"test_{name}"] = np.asarray(exact[c])[test]
    return out


def _write(path):
    import jax

    drv, exact = jax_driver()
    arrays = draws(drv, exact)
    arrays["dtype"] = np.array(str(drv.model.params[0]["kernel"].dtype))
    arrays["backend"] = np.array(jax.default_backend())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {len(arrays)} arrays, dtype {arrays['dtype']}")


def _fresh_draws(tmp_path):
    out = str(tmp_path / "draws.npz")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", JAX_ENABLE_X64="0")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--out", out], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return out


def test_committed_draws_are_tpinns(tmp_path):
    fresh = np.load(_fresh_draws(tmp_path))
    committed = np.load(WITNESS)
    assert sorted(fresh.files) == sorted(committed.files)
    assert str(committed["dtype"]) == "float32"
    for name in fresh.files:
        np.testing.assert_array_equal(committed[name], fresh[name], name)
    assert os.path.getsize(WITNESS) < 1 << 20


def test_port_grid_and_arrays_hold_the_draws():
    from tpinn.config import SimulationOptions as JaxOptions
    from tpinn.geometry import space_time_grid as jax_grid
    from tpinn_torch import witness
    from tpinn_torch.cases import cavity_unsteady as cu

    w = witness.load_draws(WITNESS)
    grid = witness.space_time_grid(torch.float32)
    spec = _jax_example().build_spec(None)
    (lx, ux), (ly, uy) = spec.extents
    n1, n2 = spec.grid_shape
    import jax.numpy as jnp

    ref = jax_grid(
        jnp.asarray(np.arange(0.0, spec.time_horizon, step=spec.dt),
                    jnp.float32),
        jnp.asarray(np.linspace(lx, ux, n1 + 1), jnp.float32),
        jnp.asarray(np.linspace(ly, uy, n2 + 1), jnp.float32))
    np.testing.assert_array_equal(grid.numpy(), np.asarray(ref))
    assert grid.shape == (100 * 101 ** 2, 3)
    assert {k: len(v) for k, v in w["idx_set"].items()} == {
        "PDE": 10000, "Vel": 50, "Pres": 0, "Test": 1000}
    assert w["params"][0]["kernel"].shape == (3, 32)
    # the draws' options (the example's file) are the ones witness trains at
    assert cu.default_options().__dict__ == JaxOptions.from_file(
        os.path.join(_EXAMPLE, "simulation_options.txt")).__dict__


@pytest.fixture(scope="module")
def f64_pair():
    """The JAX driver at seed 0 in float64 and the port's driver built from
    its draws (the f64 draws of the same seed: the witness's procedure at
    the precision of the tests)."""
    from tpinn_torch import witness

    jd, exact = jax_driver()
    arrays = draws(jd, exact)
    td = witness.driver(witness.arrays_from(arrays), exact, device="cpu",
                        dtype=torch.float64, save_results=False)
    return jd, td


def test_port_from_the_draws_evaluates_as_tpinn(f64_pair):
    import jax

    import tpinn as jns

    jd, td = f64_pair
    assert td.dom_grid.shape == (1_020_100, 3)
    np.testing.assert_array_equal(td.dom_grid.numpy(),
                                  np.asarray(jd.dom_grid))
    assert (td.norm.norm_vel, td.norm.norm_pre) == (jd.norm.norm_vel,
                                                    jd.norm.norm_pre)
    pb = jns.OptimizationProblem(jd.model.variables, jd.losses,
                                 jd.losses_test)
    total, train, test = jax.device_get(pb.eval_jit()(jd.model.params))
    from tpinn_torch.problem import OptimizationProblem

    got = OptimizationProblem(td.model, td.losses, td.losses_test).eval_all()
    assert abs(got[0] / float(total) - 1.0) < EVAL_BAR
    want = {**train, **test}
    raws = {**got[1], **got[2]}
    assert sorted(raws) == sorted(want)
    for name, v in want.items():
        assert abs(raws[name] / float(v) - 1.0) < EVAL_BAR, name


def test_witness_run_cut_down(tmp_path):
    """``witness.run`` from the committed draws in float32 with its stages
    cut to 2 + 2 + 2: the report, the run folder for the polish, the
    history's rounds running on, and the global dtype put back."""
    from tpinn_torch import config, witness

    data = series_dir(tmp_path / "data")
    rep = witness.run("cut", str(data), str(tmp_path / "runs"),
                      str(tmp_path / "logs"), draws_path=WITNESS,
                      dtype=torch.float32, device="cpu",
                      stages={"adam": 2, "cosine": 2, "bfgs": 2})
    assert config.get_dtype() == torch.float64
    with open(tmp_path / "logs" / "summary_cut.json") as f:
        assert json.load(f)["stage2"]["test"] == rep["stage2"]["test"]
    assert max(rep["oracle_gap"].values()) < 1e-12
    assert [r["name"] for r in rep["history"]["rounds"]] == [
        "keras_Adam", "keras_Adam", "jax_BFGS"]
    assert rep["history"]["runs_on"] and rep["dtype"] == "torch.float32"
    assert {"History_Loss.json", "Model.json", "checkpoint.pkl"} <= set(
        os.listdir(rep["folder"]))
    assert set(rep["stage2"]["test"]) == set(witness.TARGETS)


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=WITNESS)
    _write(ap.parse_args().out)
