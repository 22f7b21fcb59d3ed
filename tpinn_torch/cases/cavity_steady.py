"""Steady lid-driven cavity, U = 500, ν = 1 (Re = 500), on the unit square.

The exact data comes from the port's cavity oracle, made once by
:func:`tpinn_torch.oracles.generate.generate_cavity_steady` (n_solver 128,
pseudo-time to t_end 40) into ``BASE/data/SteadyCase`` and reused: the
vertex fields (``navier-stokes_cavity_steady.h5``, or ``.npz`` where h5py
is missing) train the case, the regular-grid ``..._r.csv`` gives the exact
contours.  The losses are the three PDE residuals (on a CUDA card through
the fused NS kernels), Dirichlet data on the four edges (u = 500 on the
lid), noisy velocity fitting and one pressure-fitting point.  Run with::

    python -m tpinn_torch.cases.cavity_steady --base-dir OUT \
        [--epochs N] [--second-round scipy|jax|jax-bfgs|lm|adam|none] \
        [--resume OUT/Test_Case_#001] [--load OUT/Test_Case_#001] \
        [--n-solver 128] [--scratch] [--seed 0] [--device cpu]

The options come from ``OUT/simulation_options.txt`` when it exists, else
the reference run's (1,000 PDE, 1,000 boundary, 100 velocity and 1
pressure points, 1 % noise, 10,000 second-round iterations).  The second
round defaults to "scipy" (the on-device dense BFGS).  ``--load`` reloads a
saved run and skips training, ``--resume`` continues one.  On the card the
oracle's full march (13,150 projection steps at n_solver 128) takes tens
of minutes (PERF.md); a copy or symlink of ready data in
``OUT/data/SteadyCase`` is read instead.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpinn_torch import checkpoint, config, utils
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import SECOND_ROUND_CHOICES, CaseSpec, StandardNSDriver
from tpinn_torch.oracles import generate, io
from tpinn_torch.pipeline import NSPhysics

U_LID = 500.0
T_END = 40.0

LOSS_GROUPS = {
    "Test_Loss": ["u_test", "v_test", "p_test"],
    "Equations_Residuals": ["PDE_MASS", "PDE_MOMU", "PDE_MOMV"],
    "Boundary_Cond_U": ["BCD_u_x0", "BCD_u_x1", "BCD_u_y0", "BCD_u_y1"],
    "Boundary_Cond_V": ["BCD_v_x0", "BCD_v_x1", "BCD_v_y0", "BCD_v_y1"],
    "Fitting Loss": ["Fit_u", "Fit_v", "Fit_p"],
}


def load_exact(data_dir: str, n_solver: int = 128, device=None,
               counts=None):
    """The exact (u, v, p) at the 101² vertices, the pressure recentred:
    the oracle's fields in ``data_dir/SteadyCase``, made there first if
    missing (on ``device``; ``counts`` collects its pressure solves)."""
    folder = generate.generate_cavity_steady(
        data_dir, U=U_LID, n_solver=n_solver, t_end=T_END, device=device,
        counts=counts)
    u, v, p = io.read_fields(io.find_steady_path(folder))
    return u, v, p - np.mean(p)


def exact_grids(data_dir: str, shape=(100, 100)):
    """The exact (u, v, p) on the 100 × 100 plotting grid from the
    regular-grid csv, the pressure recentred."""
    csv = io.read_regular_csv(os.path.join(data_dir, "SteadyCase",
                                           generate.STEADY_CSV))
    p = csv["p"].reshape(shape)
    return csv["ux"].reshape(shape), csv["uy"].reshape(shape), p - np.mean(p)


def build_spec(exact_data) -> CaseSpec:
    return CaseSpec(
        name="Cavity_Steady",
        extents=[(0.0, 1.0), (0.0, 1.0)],
        grid_shape=(100, 100),
        physics=NSPhysics(conv=1.0, visc=1.0),
        exact_data=exact_data,
        bnd_val={
            0: {"BOT": 0.0, "DX": 0.0, "TOP": U_LID, "SX": 0.0},
            1: {"BOT": 0.0, "DX": 0.0, "TOP": 0.0, "SX": 0.0},
        },
        weights={"PDE_MASS": 1e1},
        pressure_gauge="fit",
    )


def default_options() -> SimulationOptions:
    # the reference run: 1000 PDE / 1000 BC / 100 vel + 1 pres, 1 % noise
    return SimulationOptions(
        epochs=10000, noise_fit=0.01, noise_bnd=0.01,
        n_pde=1000, n_bc=1000, n_ic=100, n_vel=100, n_pres=1, n_test=1000,
    )


def main(epochs=None, save_results=True, base_dir=None, second_round="scipy",
         seed=0, n_solver=128, load_from=None, resume_from=None, *,
         device=None) -> StandardNSDriver:
    """Train the case into a run folder under ``base_dir`` (default: the
    working directory): Adam for 100 epochs, then ``second_round`` for
    ``epochs`` iterations (the options' when None), then the artifacts
    (without the figures where matplotlib is missing).  ``load_from``
    reloads a saved run (weights and history) and skips training;
    ``resume_from`` continues one."""
    device = config.resolve_device(device)
    cwd = base_dir or os.getcwd()
    opts_file = os.path.join(cwd, "simulation_options.txt")
    opts = (SimulationOptions.from_file(opts_file)
            if os.path.exists(opts_file) else default_options())
    if epochs is not None:
        opts.epochs = epochs
    data_dir = os.path.join(cwd, "data")
    driver = StandardNSDriver(
        build_spec(load_exact(data_dir, n_solver, device)), opts,
        base_dir=cwd, save_results=save_results, seed=seed,
        second_round=second_round, device=device)
    if load_from:
        loaded, history = checkpoint.load_experiment(load_from,
                                                     device=device)
        driver.model.set_params(loaded.params)
        driver.train(skip_training=True, callbacks=False)
        if history is not None:
            driver.pb.history = history
    else:
        driver.train(resume_from=resume_from)
    if utils.has_module("matplotlib"):
        driver.save_artifacts(loss_groups=LOSS_GROUPS,
                              exact_grids=exact_grids(data_dir))
    else:
        weights = driver.save_experiment()
        driver.write_recap()
        print(f"matplotlib is not installed: wrote Model.json, {weights}, "
              "History_Loss.json, checkpoint.pkl and Test_Options.txt, no "
              "figures")
    print("final test losses:", driver.final_test_losses())
    return driver


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-dir", default=None,
                    help="run folders, data and simulation_options.txt "
                         "(default: the working directory)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="second-round iterations (default: the options')")
    ap.add_argument("--second-round", default="scipy",
                    choices=SECOND_ROUND_CHOICES,
                    help="'scipy', 'jax-bfgs' and 'bfgs' run the on-device "
                         "dense BFGS, whose carry a checkpoint resumes; "
                         "'jax' the on-device L-BFGS; 'scipy-parity' / "
                         "'scipy-host' the host scipy BFGS; 'lm' "
                         "Levenberg-Marquardt; 'adam' the cosine-decay "
                         "Adam round")
    ap.add_argument("--scratch", action="store_true",
                    help="write into Last_Training instead of Test_Case_#NNN")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default=None, metavar="FOLDER",
                    help="continue the saved run in FOLDER: load its "
                         "weights, history and checkpoint, run only the "
                         "second round")
    ap.add_argument("--n-solver", type=int, default=128)
    ap.add_argument("--load", default=None, metavar="FOLDER",
                    help="reload a saved run and skip training")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    main(args.epochs, save_results=not args.scratch, base_dir=args.base_dir,
         second_round=args.second_round, seed=args.seed,
         n_solver=args.n_solver, load_from=args.load,
         resume_from=args.resume, device=args.device)


if __name__ == "__main__":
    cli()
