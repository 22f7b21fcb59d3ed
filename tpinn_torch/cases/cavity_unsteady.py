"""Unsteady lid-driven cavity: the space-time PINN on (t, x, y).

U = 1, ν = 1, horizon T = 1e-2, step dt = 1e-4: 100 time slices of the
101² spatial nodes, about 10⁶ space-time points, with the cavity oracle's
per-step fields as exact data (made once by
:func:`tpinn_torch.oracles.generate.generate_cavity_unsteady` into
``BASE/data/UnsteadyCase`` and reused).  The momentum residual gains the
∂t U term (input column 0 is t); the losses are the three PDE residuals
(on a CUDA card through the fused NS kernels at d_in = 3), Dirichlet data
on the four edges, the t = 0 condition (IC_u, IC_v, IC_p) and noisy
velocity-fitting points.  Run with::

    python -m tpinn_torch.cases.cavity_unsteady --base-dir OUT \
        [--epochs N] [--second-round scipy|jax|jax-bfgs|lm|adam|none] \
        [--pde-weights MASS,MOMU,MOMV] [--resume OUT/Test_Case_#001] \
        [--device cpu]

The options come from ``OUT/simulation_options.txt`` when it exists, else
the reference run's (10,000 PDE, 1,000 boundary, 1,000 initial and 50
velocity points, 5 % noise, 5,000 epochs).  The second round defaults to
"scipy" (the on-device dense BFGS); ``--epochs`` sets its iterations.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from tpinn_torch import utils
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import SECOND_ROUND_CHOICES, CaseSpec, StandardNSDriver
from tpinn_torch.oracles import generate, io
from tpinn_torch.pipeline import NSPhysics

T_HORIZON = 1e-2
DT = 1e-4

LOSS_GROUPS = {
    "Test_Loss": ["u_test", "v_test", "p_test"],
    "Equations_Residuals": ["PDE_MASS", "PDE_MOMU", "PDE_MOMV"],
    "Initial_Conditions": ["IC_u", "IC_v", "IC_p"],
    "Fitting Loss": ["Fit_u", "Fit_v"],
}


def load_exact(data_dir: str, device=None, counts=None):
    """The exact (u, v, p) on the space-time grid, slice after slice, each
    slice's pressure recentred: the oracle's series in ``data_dir``, made
    there first if missing (on ``device``; ``counts`` collects its
    pressure solves)."""
    folder = generate.generate_cavity_unsteady(
        data_dir, U=1.0, nu=1.0, T=T_HORIZON, dt=DT, n=100, device=device,
        counts=counts)
    return io.read_unsteady_series(folder, int(round(T_HORIZON / DT)))


def build_spec(exact_data) -> CaseSpec:
    return CaseSpec(
        name="Cavity_Unsteady",
        extents=[(0.0, 1.0), (0.0, 1.0)],
        grid_shape=(100, 100),
        physics=NSPhysics(conv=1.0, visc=1.0, time=1.0),
        exact_data=exact_data,
        bnd_val={
            0: {"BOT": 0.0, "DX": 0.0, "TOP": 1.0, "SX": 0.0},
            1: {"BOT": 0.0, "DX": 0.0, "TOP": 0.0, "SX": 0.0},
        },
        weights={"PDE_MASS": 1e1, "PDE_MOMU": 1e0, "PDE_MOMV": 1e0},
        unsteady=True,
        time_horizon=T_HORIZON,
        dt=DT,
    )


def default_options() -> SimulationOptions:
    # the reference run: 10000 PDE / 1000 BC / 1000 IC / 50 vel, 5 % noise
    return SimulationOptions(
        epochs=5000, noise_fit=0.05, noise_bnd=0.05,
        n_pde=10000, n_bc=1000, n_ic=1000, n_vel=50, n_pres=0, n_test=1000,
    )


def main(epochs=None, save_results=True, base_dir=None, second_round="scipy",
         seed=0, resume_from=None, pde_weights=None, *, device=None,
         adam_epochs: int = 100, exact_data=None,
         dtype=None) -> StandardNSDriver:
    """Train the case into a run folder under ``base_dir`` (default: the
    working directory): Adam for ``adam_epochs``, then ``second_round`` for
    ``epochs`` iterations (the options' when None), then the artifacts
    (without the figures where matplotlib is missing).

    ``pde_weights`` "MASS,MOMU,MOMV" overrides the PDE loss weights;
    ``resume_from`` continues a saved run; ``exact_data`` skips the oracle
    (e.g. data made on another device)."""
    cwd = base_dir or os.getcwd()
    opts_file = os.path.join(cwd, "simulation_options.txt")
    opts = (SimulationOptions.from_file(opts_file)
            if os.path.exists(opts_file) else default_options())
    if epochs is not None:
        opts.epochs = epochs
    if exact_data is None:
        exact_data = load_exact(os.path.join(cwd, "data"), device)
    spec = build_spec(exact_data)
    if pde_weights is not None:
        # the physics-weighted polish: PDE weights raised so that the
        # noise-free physics dominates the noisy fit and boundary rows
        mass, momu, momv = (float(w) for w in pde_weights.split(","))
        spec = dataclasses.replace(
            spec, weights={**spec.weights, "PDE_MASS": mass,
                           "PDE_MOMU": momu, "PDE_MOMV": momv})
    driver = StandardNSDriver(
        spec, opts, base_dir=cwd, save_results=save_results, seed=seed,
        second_round=second_round, adam_epochs=adam_epochs, device=device,
        dtype=dtype)
    driver.train(resume_from=resume_from)
    if utils.has_module("matplotlib"):
        driver.save_artifacts(loss_groups=LOSS_GROUPS)
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
    ap.add_argument("--adam-epochs", type=int, default=100)
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
    ap.add_argument("--pde-weights", default=None, metavar="MASS,MOMU,MOMV",
                    help="override the PDE loss weights (e.g. '1e2,1e1,1e1')")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    main(args.epochs, save_results=not args.scratch, base_dir=args.base_dir,
         second_round=args.second_round, seed=args.seed,
         resume_from=args.resume, pde_weights=args.pde_weights,
         device=args.device, adam_epochs=args.adam_epochs)


if __name__ == "__main__":
    cli()
