"""Poiseuille_Flow through the program's own path: the case's spec
(``cases/poiseuille_flow.build_spec``) and ``StandardNSDriver.from_arrays``
on the benchmark's inputs, its losses in an ``OptimizationProblem``.  No
run folder, history file or checkpoint is written."""

from __future__ import annotations

KERNEL_SOURCES = ("ns_residual.cu",)
# kernel 1 (the one-pass backward) in float64 at d_in 2 or 3
BWD_KERNEL = r"residual_kernel<(\(anonymous namespace\)::)?NSHead<double, \d>, true>"


def build(cfg: dict, inputs: dict, device, mesh=None):
    """(problem, model) on ``device``; under ``mesh`` this rank's shard."""
    from tpinn_torch.cases.poiseuille_flow import build_spec
    from tpinn_torch.config import SimulationOptions
    from tpinn_torch.driver import StandardNSDriver
    from tpinn_torch.problem import OptimizationProblem

    spec = build_spec()
    published = {"rho": spec.physics.conv, "mu": spec.physics.visc,
                 "layers": [2] + [spec.width] * spec.depth + [3],
                 "extents": [list(e) for e in spec.extents]}
    for key, value in published.items():
        if cfg[key] != value:
            raise ValueError(f"configuration {key} {cfg[key]} is not the "
                             f"case's {value}")
    for key, w in cfg["weights"].items():
        if spec.weight(key) != w:
            raise ValueError(f"weight {key} {w} is not the case's "
                             f"{spec.weight(key)}")
    opts = SimulationOptions(
        epochs=0, noise_fit=cfg["noise_fit"], noise_bnd=cfg["noise_bnd"],
        n_pde=inputs["n_pde_total"], n_bc=cfg["n_bc"], n_ic=0,
        n_vel=cfg["n_vel"], n_pres=cfg["n_pres"], n_test=cfg["n_test"])
    drv = StandardNSDriver.from_arrays(
        spec, opts, dom_grid=inputs["dom_grid"], idx_set=inputs["idx_set"],
        bnd_pts=inputs["bnd_pts"], bnd_val_num=inputs["bnd_val_num"],
        sol_noise=inputs["sol_noise"], params=inputs["params"],
        save_results=False, second_round="none", device=device, mesh=mesh)
    return OptimizationProblem(drv.model, drv.losses, drv.losses_test), \
        drv.model
