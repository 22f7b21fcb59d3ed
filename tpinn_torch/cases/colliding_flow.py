"""Colliding flow: steady Stokes flow (with the reference's weak
convection term) whose exact solution is a polynomial, on (−1, 1)².

    u = 20 x y³,   v = 5 x⁴ − 5 y⁴,   p = 60 x² y − 20 y³

Dirichlet data on all four edges, 5 velocity-fitting points and the
pressure fixed through one fitting point (the ``Fit_p`` gauge); the
convection coefficient is 1/40 (the reference multiplies the normalized
velocity by the physical gradient, i.e. 1/norm_vel with u spread 40).  The
PDE losses of the 2-32-32-32-3 tanh net go through the fused NS objective.
Run with::

    python -m tpinn_torch.cases.colliding_flow --base-dir OUT \
        [--adam-epochs 100] [--second-round scipy|jax|jax-bfgs|adam|none] \
        [--epochs N] [--device cpu]

The second round defaults to "scipy" (the on-device dense BFGS) for the
options' 10,000 iterations; ``--epochs`` sets them.  The run folder gets
the artifacts, as for :mod:`tpinn_torch.cases.poiseuille_flow`.
"""

from __future__ import annotations

from tpinn_torch.cases.poiseuille_flow import cli, run
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import CaseSpec, StandardNSDriver
from tpinn_torch.oracles import analytic
from tpinn_torch.pipeline import NSPhysics

LOSS_GROUPS = {
    "Test_Loss": ["u_test", "v_test", "p_test"],
    "Equations_Residuals": ["PDE_MASS", "PDE_MOMU", "PDE_MOMV"],
    "Boundary_Cond_U": ["BCD_u_x0", "BCD_u_x1", "BCD_u_y0", "BCD_u_y1"],
    "Boundary_Cond_V": ["BCD_v_x0", "BCD_v_x1", "BCD_v_y0", "BCD_v_y1"],
    "Fitting Loss": ["Fit_u", "Fit_v", "Fit_p"],
}


def build_spec() -> CaseSpec:
    u_f, v_f, p_f = (analytic.colliding_u, analytic.colliding_v,
                     analytic.colliding_p)
    return CaseSpec(
        name="Colliding_Flow",
        extents=[(-1.0, 1.0), (-1.0, 1.0)],
        grid_shape=(100, 100),
        physics=NSPhysics(conv=1.0 / 40.0, visc=1.0),
        exact=(u_f, v_f, p_f),
        bnd_val={
            0: {"BOT": u_f, "DX": u_f, "TOP": u_f, "SX": u_f},
            1: {"BOT": v_f, "DX": v_f, "TOP": v_f, "SX": v_f},
        },
        weights={"PDE_MASS": 1e1},
        pressure_gauge="fit",
    )


def default_options() -> SimulationOptions:
    # the values of examples/Colliding_Flow/simulation_options.txt
    return SimulationOptions(
        epochs=10000, noise_fit=0.0, noise_bnd=0.0,
        n_pde=1000, n_bc=100, n_ic=100, n_vel=5, n_pres=1, n_test=10000,
    )


def main(base_dir: str, adam_epochs: int = 100, save_results: bool = True,
         seed: int = 0, device=None, second_round: str = "scipy",
         options_file=None, epochs=None, resume_from=None
         ) -> StandardNSDriver:
    """``poiseuille_flow.run`` on this case; the options come from
    ``options_file`` when given, else the reference defaults."""
    opts = (SimulationOptions.from_file(options_file)
            if options_file else default_options())
    return run(build_spec(), opts, LOSS_GROUPS, base_dir,
               adam_epochs=adam_epochs, save_results=save_results, seed=seed,
               device=device, second_round=second_round, epochs=epochs,
               resume_from=resume_from)


if __name__ == "__main__":
    cli(main)
