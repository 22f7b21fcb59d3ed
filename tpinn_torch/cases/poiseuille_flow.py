"""Poiseuille (lava channel) flow, the canonical full-pipeline case.

Steady dimensional Navier–Stokes in a 1 × 0.1 channel, ρ=3100, μ=890,
driven by a 1e6 Pa pressure drop: Dirichlet walls and parabolic inflow,
traction (Neumann) outflow and noisy velocity-fitting points.  Run with::

    python -m tpinn_torch.cases.poiseuille_flow --base-dir OUT --adam-epochs 100
"""

from __future__ import annotations

import argparse

from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import CaseSpec, StandardNSDriver
from tpinn_torch.oracles import analytic
from tpinn_torch.pipeline import NSPhysics

PRM = analytic.PoiseuilleParams()


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


def main(base_dir: str, adam_epochs: int = 100, save_results: bool = True,
         seed: int = 0, device=None, second_round: str = "none",
         options_file=None) -> StandardNSDriver:
    """Train the case into a run folder under ``base_dir``; the options come
    from ``options_file`` when given, else the reference defaults."""
    opts = (SimulationOptions.from_file(options_file)
            if options_file else default_options())
    driver = StandardNSDriver(
        build_spec(), opts, base_dir=base_dir, save_results=save_results,
        seed=seed, second_round=second_round, adam_epochs=adam_epochs,
        device=device)
    driver.train()
    print("final test losses:", driver.final_test_losses())
    return driver


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--adam-epochs", type=int, default=100)
    ap.add_argument("--options", default=None,
                    help="a simulation_options.txt in the legacy format")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.base_dir, adam_epochs=args.adam_epochs, seed=args.seed,
         device=args.device, options_file=args.options)
