"""tpinn_torch — the PyTorch/CUDA port of tpinn for NVIDIA Hopper.

The JAX package ``tpinn`` stays the reference; this package computes the
same functions with PyTorch tensors and hand-written CUDA kernels
(tpinn_torch/kernels).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``, which takes every kernel's plain PyTorch version.
"""

from tpinn_torch import config
from tpinn_torch.config import SimulationOptions, get_dtype, set_dtype

__all__ = ["config", "SimulationOptions", "get_dtype", "set_dtype"]
