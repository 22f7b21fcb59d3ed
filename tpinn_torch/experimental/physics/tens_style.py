"""nisaba-parity operator surface: the call sites of the reference drivers
use exactly

  gradient_scalar(tape, u, x)
  divergence_vector(tape, u_vect, x, dim)
  laplacian_scalar(tape, u, x, dim)
"""

from tpinn_torch.operators import (
    divergence_vector,
    gradient_scalar,
    laplacian_scalar,
    laplacian_vector,
)

__all__ = [
    "gradient_scalar",
    "divergence_vector",
    "laplacian_scalar",
    "laplacian_vector",
]
