"""Domains, grids, boundary samplers and point-set splits.

The shared sampling stages of the reference drivers: uniform tensor-product
grids flattened row-major with x fastest, a random permutation split into
disjoint {PDE, Vel, Pres, Test} index sets, per-edge uniform boundary
sampling, space-time grids ``(t, x, y)`` with t slowest and the t = 0
initial-condition samples of the unsteady case, and gaussian noise.
Random draws come from explicit
``torch.Generator``s on the CPU, so a seed gives the same points on every
device; the tensors are then moved to the requested device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpinn_torch import config


def linspace_or_random(generator: Optional[torch.Generator], lo: float,
                       hi: float, n: int, uniform: bool = True,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """n nodes from lo to hi: evenly spaced (numpy's linspace) or, with
    ``uniform`` off, uniform random draws."""
    dtype = dtype or config.get_dtype()
    if uniform:
        return torch.as_tensor(np.linspace(lo, hi, n), dtype=dtype)
    u = torch.rand(n, generator=generator, dtype=dtype)
    return lo + u * (hi - lo)


def tensor_grid(x_vec, y_vec) -> torch.Tensor:
    """Row-major (x fastest) 2-D tensor-product grid: (len(x)*len(y), 2)."""
    yy, xx = torch.meshgrid(torch.as_tensor(y_vec), torch.as_tensor(x_vec),
                            indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def space_time_grid(t_vec, x_vec, y_vec) -> torch.Tensor:
    """(t, x, y) grid with t slowest, then y, then x: (len(t)·len(y)·len(x),
    3), the reference's ordering, so row k·len(x)·len(y) + j·len(x) + i is
    (t_k, x_i, y_j)."""
    tt, yy, xx = torch.meshgrid(torch.as_tensor(t_vec), torch.as_tensor(y_vec),
                                torch.as_tensor(x_vec), indexing="ij")
    return torch.stack([tt.reshape(-1), xx.reshape(-1), yy.reshape(-1)],
                       dim=-1)


def rect_grid(extents: Sequence[Tuple[float, float]], shape: Sequence[int],
              dtype: Optional[torch.dtype] = None, uniform: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """2-D rectangle grid with (n1+1)×(n2+1) nodes like the reference: a
    uniform one, or with ``uniform`` off one of random x and y nodes drawn
    from ``generator`` (x first).  numpy's linspace gives the JAX package's
    uniform grid to the bit on the Poiseuille and cavity extents, and
    within one ulp on others."""
    (lx, ux), (ly, uy) = extents
    n1, n2 = shape
    if not uniform and generator is None:
        generator = torch.Generator().manual_seed(0)
    x_vec = linspace_or_random(generator, lx, ux, n1 + 1, uniform, dtype)
    y_vec = linspace_or_random(generator, ly, uy, n2 + 1, uniform, dtype)
    return tensor_grid(x_vec, y_vec)


def split_indices(
    generator: torch.Generator, n_total: int, counts: Dict[str, int],
    order: Sequence[str] = ("PDE", "Vel", "Pres", "Test"),
) -> Dict[str, np.ndarray]:
    """Disjoint random index subsets:
    ``np.split(permutation(n), cumsum(counts))[:-1]`` as host arrays."""
    perm = torch.randperm(n_total, generator=generator).numpy()
    sizes = [counts[k] for k in order]
    splits = np.split(perm, np.cumsum(sizes))[:-1]
    return {k: v for k, v in zip(order, splits)}


def sample_box(generator: torch.Generator, n: int, minval, maxval,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Uniform samples in an axis-aligned box; degenerate axes give edges."""
    dtype = dtype or config.get_dtype()
    minval = torch.as_tensor(minval, dtype=dtype)
    maxval = torch.as_tensor(maxval, dtype=dtype)
    u = torch.rand(n, minval.shape[-1], generator=generator, dtype=dtype)
    return minval + u * (maxval - minval)


def rect_boundary_points(
    generator: torch.Generator,
    extents: Sequence[Tuple[float, float]],
    n_per_edge: int,
    time_horizon: Optional[float] = None,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """The four reference edges {BOT, DX, TOP, SX} of a rectangle; with
    ``time_horizon`` set the points get a leading uniform t coordinate."""
    (lx, ux), (ly, uy) = extents
    edges = {
        "BOT": ([lx, ly], [ux, ly]),
        "DX": ([ux, ly], [ux, uy]),
        "TOP": ([lx, uy], [ux, uy]),
        "SX": ([lx, ly], [lx, uy]),
    }
    out = {}
    for name, (mn, mx) in edges.items():
        if time_horizon is not None:
            mn = [0.0] + list(mn)
            mx = [time_horizon] + list(mx)
        out[name] = sample_box(generator, n_per_edge, mn, mx, dtype)
    return out


def initial_condition_points(generator: torch.Generator,
                             extents: Sequence[Tuple[float, float]], n: int,
                             dtype: Optional[torch.dtype] = None
                             ) -> torch.Tensor:
    """n uniform samples of the t = 0 slice: (0, x, y) rows."""
    (lx, ux), (ly, uy) = extents
    return sample_box(generator, n, [0.0, lx, ly], [0.0, ux, uy], dtype)


def generate_noise(generator: torch.Generator, n: int, factor: float = 0.0,
                   sd: float = 1.0, mean: float = 0.0,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """factor · N(mean, sd) — the reference's generate_noise."""
    dtype = dtype or config.get_dtype()
    return (mean + sd * torch.randn(n, generator=generator, dtype=dtype)) * factor


def spread(vec) -> float:
    """max − min; the reference's normalization constant."""
    v = vec.detach().cpu().numpy() if torch.is_tensor(vec) else np.asarray(vec)
    return float(np.max(v) - np.min(v))


class Normalization:
    """Velocity/pressure spread-normalization bundle.

    norm_vel = max(spread(u), spread(v)); norm_pre = spread(p); the
    momentum residual is rescaled by 1/max(norm_pre, norm_vel)."""

    def __init__(self, u_ex, v_ex, p_ex):
        self.norm_vel = max(spread(u_ex), spread(v_ex)) or 1.0
        self.norm_pre = spread(p_ex) or 1.0

    @property
    def residual_scale(self) -> float:
        return 1.0 / max(self.norm_pre, self.norm_vel)
