"""tpinn_torch — the PyTorch/CUDA port of tpinn for NVIDIA Hopper.

The JAX package ``tpinn`` stays the reference; this package computes the
same functions with PyTorch tensors and hand-written CUDA kernels
(tpinn_torch/kernels).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``, which takes every kernel's plain PyTorch version.

The top-level namespace mirrors nisaba's, so a case reads like the
reference's (``import tpinn_torch as ns``):

    ns.GradientTape(persistent=True)
    ns.experimental.physics.tens_style.{gradient_scalar, laplacian_scalar, ...}
    ns.Loss / ns.LossMeanSquares
    ns.OptimizationProblem(model.variables, losses, losses_test)
    ns.minimize(pb, "keras" | "scipy" | "jax", ...)
    ns.models.MLP, ns.optimizers.Adam, ns.utils.plot_history
"""

from tpinn_torch import config
from tpinn_torch import experimental
from tpinn_torch import geometry
from tpinn_torch import models
from tpinn_torch import optimizers
from tpinn_torch import oracles
from tpinn_torch import utils
from tpinn_torch.config import SimulationOptions, get_dtype, set_dtype
from tpinn_torch.losses import Loss, LossMeanSquares
from tpinn_torch.optimize import minimize
from tpinn_torch.problem import OptimizationProblem
from tpinn_torch.tape import GradientTape

__all__ = [
    "config",
    "SimulationOptions",
    "get_dtype",
    "set_dtype",
    "GradientTape",
    "Loss",
    "LossMeanSquares",
    "OptimizationProblem",
    "minimize",
    "models",
    "optimizers",
    "utils",
    "geometry",
    "oracles",
    "experimental",
]
