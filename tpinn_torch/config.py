"""Global configuration: dtype policy, device resolution and the legacy
options-file parser.

The port trains in float64 by default, as the JAX package does with x64
enabled (the reference runs float64 throughout).  Entry points run on the
CUDA card unless the caller asks for ``device="cpu"``; with no card and no
explicit CPU request they raise instead of carrying on on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

_dtype_override: Optional[torch.dtype] = None


def get_dtype() -> torch.dtype:
    """The global float dtype (float64 unless overridden)."""
    return _dtype_override if _dtype_override is not None else torch.float64


def set_dtype(dtype: Optional[torch.dtype]) -> None:
    """Override the global float dtype (None restores float64)."""
    global _dtype_override
    _dtype_override = dtype


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one.  Raises when no CUDA device exists and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpinn_torch runs on a CUDA device; none is available. "
                "Pass device='cpu' to run the plain PyTorch path on the CPU."
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class SimulationOptions:
    """Typed run configuration mirroring the 10-field legacy
    ``simulation_options.txt`` format (a zero point-count disables that
    loss group)."""

    epochs: int = 10000
    noise_fit: float = 0.0
    noise_bnd: float = 0.0
    n_pde: int = 1000
    n_bc: int = 100
    n_ic: int = 100
    n_vel: int = 10
    n_pres: int = 0
    n_test: int = 1000

    @property
    def n_pts(self) -> dict:
        return {
            "PDE": self.n_pde,
            "BC": self.n_bc,
            "IC": self.n_ic,
            "Vel": self.n_vel,
            "Pres": self.n_pres,
            "Test": self.n_test,
        }

    @property
    def use_collloss(self) -> bool:
        return self.n_pde > 0

    @property
    def use_boundary(self) -> bool:
        return self.n_bc > 0

    @property
    def use_initialc(self) -> bool:
        return self.n_ic > 0

    @property
    def fit_velocity(self) -> bool:
        return self.n_vel > 0

    @property
    def fit_pressure(self) -> bool:
        return self.n_pres > 0

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "SimulationOptions":
        """Parse the legacy every-other-line text format: line 0 is the
        ``###`` header, then value lines at odd positions."""
        with open(path) as f:
            fields = f.readlines()[0:-1:2]
        return cls(
            epochs=int(fields[1]),
            noise_fit=float(fields[2]),
            noise_bnd=float(fields[3]),
            n_pde=int(fields[4]),
            n_bc=int(fields[5]),
            n_ic=int(fields[6]),
            n_vel=int(fields[7]),
            n_pres=int(fields[8]),
            n_test=int(fields[9]),
        )
