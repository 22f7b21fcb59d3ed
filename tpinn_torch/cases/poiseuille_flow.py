"""Poiseuille (lava channel) flow, the canonical full-pipeline case.

Steady dimensional Navier–Stokes in a 1 × 0.1 channel, ρ=3100, μ=890,
driven by a 1e6 Pa pressure drop: Dirichlet walls and parabolic inflow,
traction (Neumann) outflow and noisy velocity-fitting points.  Run with::

    python -m tpinn_torch.cases.poiseuille_flow --base-dir OUT \
        --adam-epochs 100 --second-round none
    python -m tpinn_torch.cases.poiseuille_flow --base-dir OUT \
        --adam-epochs 100 --second-round jax-bfgs --epochs 20
    python -m tpinn_torch.cases.poiseuille_flow --base-dir OUT \
        --adam-epochs 100 --second-round jax --epochs 20
    python -m tpinn_torch.cases.poiseuille_flow --base-dir OUT \
        --second-round jax-bfgs --epochs 20 --resume OUT/Test_Case_#001
    python -m tpinn_torch.cases.poiseuille_flow --base-dir OUT --adam-epochs 0 \
        --second-round lm --epochs 4

``--second-round`` defaults to "scipy" (the on-device dense BFGS); "jax"
runs the on-device L-BFGS and "adam" the cosine-decay Adam round.
``--epochs`` is the second round's iteration count (default: the options'
``TRAINING EPOCHS``).  ``--resume FOLDER`` continues a saved run in FOLDER:
its weights, history and checkpoint are loaded, the Adam round is skipped
and the second round (a BFGS round adopting the checkpointed carry)
appends to the history.  The run folder gets the artifacts (Model.json, the
weights, History_Loss.json, checkpoint.pkl, Test_Options.txt, and the two
figures where matplotlib is installed).  ``TPINN_USE_PALLAS=1`` in the
environment routes the LM round's residual evaluations through the
Taylor-bundle kernel.
"""

from __future__ import annotations

import argparse

from tpinn_torch import utils
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import SECOND_ROUND_CHOICES, CaseSpec, StandardNSDriver
from tpinn_torch.oracles import analytic
from tpinn_torch.pipeline import NSPhysics

PRM = analytic.PoiseuilleParams()

LOSS_GROUPS = {
    "Test_Loss": ["u_test", "v_test", "p_test"],
    "Equations_Residuals": ["PDE_MASS", "PDE_MOMU", "PDE_MOMV"],
    "Boundary_Cond_U": ["BCD_u_x0", "BCN_u_x1", "BCD_u_y0", "BCD_u_y1"],
    "Boundary_Cond_V": ["BCD_v_x0", "BCN_v_x1", "BCD_v_y0", "BCD_v_y1"],
    "Fitting Loss": ["Fit_u", "Fit_v"],
}


def build_spec() -> CaseSpec:
    u_f = lambda x: analytic.poiseuille_u(x, PRM)
    v_f = lambda x: analytic.poiseuille_v(x, PRM)
    p_f = lambda x: analytic.poiseuille_p(x, PRM)
    return CaseSpec(
        name="Poiseuille_Flow",
        extents=[(0.0, 1.0), (0.0, 0.1)],
        grid_shape=(100, 25),
        physics=NSPhysics(conv=PRM.rho, visc=PRM.mu),
        exact=(u_f, v_f, p_f),
        bnd_val={
            # u: no-slip walls, parabolic inflow, outflow traction = p_out
            0: {"BOT": 0.0, "TOP": 0.0, "SX": u_f, "DX": PRM.p_out},
            1: {"BOT": 0.0, "TOP": 0.0, "SX": 0.0, "DX": 0.0},
        },
        neumann={("DX", 0): 0, ("DX", 1): 0},  # σ·e_x at the outlet
        weights={"PDE_MASS": 1e1},
    )


def default_options() -> SimulationOptions:
    # the values of examples/Poiseuille_Flow/simulation_options.txt
    return SimulationOptions(
        epochs=10000, noise_fit=0.0, noise_bnd=0.0,
        n_pde=1000, n_bc=100, n_ic=100, n_vel=10, n_pres=0, n_test=1000,
    )


def run(spec: CaseSpec, opts: SimulationOptions, loss_groups: dict,
        base_dir: str, adam_epochs: int = 100, save_results: bool = True,
        seed: int = 0, device=None, second_round: str = "scipy",
        epochs=None, resume_from=None) -> StandardNSDriver:
    """Train a driver case into a run folder under ``base_dir`` (or
    continue the saved run in ``resume_from``): Adam for ``adam_epochs``,
    then ``second_round`` for ``epochs`` iterations (the options' epochs
    when None), then the artifacts (without the figures where matplotlib
    is missing)."""
    if epochs is not None:
        opts.epochs = epochs
    driver = StandardNSDriver(
        spec, opts, base_dir=base_dir, save_results=save_results, seed=seed,
        second_round=second_round, adam_epochs=adam_epochs, device=device)
    driver.train(resume_from=resume_from)
    if utils.has_module("matplotlib"):
        driver.save_artifacts(loss_groups=loss_groups)
    else:
        weights = driver.save_experiment()
        driver.write_recap()
        print(f"matplotlib is not installed: wrote Model.json, {weights}, "
              "History_Loss.json, checkpoint.pkl and Test_Options.txt, no "
              "figures")
    print("final test losses:", driver.final_test_losses())
    return driver


def main(base_dir: str, adam_epochs: int = 100, save_results: bool = True,
         seed: int = 0, device=None, second_round: str = "scipy",
         options_file=None, epochs=None,
         resume_from=None) -> StandardNSDriver:
    """``run`` on this case; the options come from ``options_file`` when
    given, else the reference defaults."""
    opts = (SimulationOptions.from_file(options_file)
            if options_file else default_options())
    return run(build_spec(), opts, LOSS_GROUPS, base_dir,
               adam_epochs=adam_epochs, save_results=save_results, seed=seed,
               device=device, second_round=second_round, epochs=epochs,
               resume_from=resume_from)


def cli(main_fn) -> None:
    """The command line of a driver case's ``main``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--adam-epochs", type=int, default=100)
    ap.add_argument("--options", default=None,
                    help="a simulation_options.txt in the legacy format")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    ap.add_argument("--second-round", default="scipy", choices=SECOND_ROUND_CHOICES,
                    help="'scipy', 'jax-bfgs' and 'bfgs' run the on-device "
                         "dense BFGS, whose carry a checkpoint resumes; "
                         "'jax' the on-device L-BFGS; 'scipy-parity' / "
                         "'scipy-host' the host scipy BFGS; 'adam' the "
                         "cosine-decay Adam round")
    ap.add_argument("--epochs", type=int, default=None,
                    help="second-round iterations (default: the options')")
    ap.add_argument("--scratch", action="store_true",
                    help="write into Last_Training instead of Test_Case_#NNN")
    ap.add_argument("--resume", default=None, metavar="FOLDER",
                    help="continue the saved run in FOLDER: load its "
                         "weights, history and checkpoint, run only the "
                         "second round")
    args = ap.parse_args()
    main_fn(args.base_dir, adam_epochs=args.adam_epochs, seed=args.seed,
            device=args.device, options_file=args.options,
            second_round=args.second_round, epochs=args.epochs,
            save_results=not args.scratch, resume_from=args.resume)


if __name__ == "__main__":
    cli(main)
