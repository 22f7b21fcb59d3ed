"""Poiseuille flow without the inflow Dirichlet condition: the inflow
profile is recovered from the physics, the wall and outflow conditions
and 50 noisy velocity-fitting points (noise 1e-3).

The main case's spec (:mod:`tpinn_torch.cases.poiseuille_flow`) with no
"SX" (inflow) entries in its boundary values, so no loss sees the inflow
edge.  Run with::

    python -m tpinn_torch.cases.poiseuille_no_bcs --base-dir OUT \
        [--adam-epochs 100] [--second-round scipy|jax|...] [--epochs N] \
        [--device cpu]
"""

from __future__ import annotations

from tpinn_torch.cases.poiseuille_flow import cli, run
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import CaseSpec, StandardNSDriver
from tpinn_torch.oracles import analytic
from tpinn_torch.pipeline import NSPhysics

PRM = analytic.PoiseuilleParams()

LOSS_GROUPS = {
    "Test_Loss": ["u_test", "v_test", "p_test"],
    "Equations_Residuals": ["PDE_MASS", "PDE_MOMU", "PDE_MOMV"],
    "Fitting Loss": ["Fit_u", "Fit_v"],
}


def build_spec() -> CaseSpec:
    u_f = lambda x: analytic.poiseuille_u(x, PRM)
    v_f = lambda x: analytic.poiseuille_v(x, PRM)
    p_f = lambda x: analytic.poiseuille_p(x, PRM)
    return CaseSpec(
        name="Poiseuille_No_BCs",
        extents=[(0.0, 1.0), (0.0, 0.1)],
        grid_shape=(100, 25),
        physics=NSPhysics(conv=PRM.rho, visc=PRM.mu),
        exact=(u_f, v_f, p_f),
        bnd_val={
            # walls and traction outflow only: no "SX" (inflow) entries
            0: {"BOT": 0.0, "TOP": 0.0, "DX": PRM.p_out},
            1: {"BOT": 0.0, "TOP": 0.0, "DX": 0.0},
        },
        neumann={("DX", 0): 0, ("DX", 1): 0},
        weights={"PDE_MASS": 1e1},
    )


def default_options() -> SimulationOptions:
    # more fit points than the main case: they carry the inflow information
    return SimulationOptions(
        epochs=10000, noise_fit=1e-3, noise_bnd=0.0,
        n_pde=1000, n_bc=100, n_ic=0, n_vel=50, n_pres=0, n_test=1000,
    )


def main(base_dir: str, adam_epochs: int = 100, save_results: bool = True,
         seed: int = 0, device=None, second_round: str = "scipy",
         options_file=None, epochs=None, resume_from=None
         ) -> StandardNSDriver:
    """``poiseuille_flow.run`` on this case; the options come from
    ``options_file`` when given, else this case's defaults."""
    opts = (SimulationOptions.from_file(options_file)
            if options_file else default_options())
    return run(build_spec(), opts, LOSS_GROUPS, base_dir,
               adam_epochs=adam_epochs, save_results=save_results, seed=seed,
               device=device, second_round=second_round, epochs=epochs,
               resume_from=resume_from)


if __name__ == "__main__":
    cli(main)
