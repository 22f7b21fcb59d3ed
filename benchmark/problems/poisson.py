"""The Poisson problem through the program's own path:
``cases/poisson.from_arrays`` on the benchmark's points and weights."""

from __future__ import annotations

KERNEL_SOURCES = ("poisson_residual.cu",)
# kernel 3 (the one-pass backward) in float64
BWD_KERNEL = r"residual_kernel<(\(anonymous namespace\)::)?PoissonHead<double>, true>"


def build(cfg: dict, inputs: dict, device, mesh=None):
    """(problem, model) on ``device``; the case has no point-mesh path."""
    from tpinn_torch.cases import poisson

    if mesh is not None:
        raise ValueError("the Poisson case runs on one device")
    hi = cfg["extents"][0][1]
    if (cfg["layers"] != [2, 20, 20, 20, 1] or hi != poisson.W
            or cfg["weights"] != {"PDE": 2.0, "BC": 1.0}):
        raise ValueError("the configuration is not the case's")
    pb, model = poisson.from_arrays(inputs["x_pde"], inputs["x_bc"],
                                    inputs["x_test"], inputs["params"],
                                    device=device)
    return pb, model
