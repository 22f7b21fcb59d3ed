"""Named, weighted losses (nisaba ``ns.Loss`` / ``ns.LossMeanSquares``).

* ``LossMeanSquares(name, fn, weight, normalization)``: ``fn`` returns a
  residual vector r; the logged raw value is ``mean((r/normalization)**2)``
  and the global objective receives ``weight * raw``.
* ``Loss``: a generic scalar loss.
* ``PrecomputedMeanSquares``: ``fn`` already returns the MSE scalar (the
  fused residual objective computes all three PDE MSEs at once).

History_Loss.json keeps per-loss ``{weight, non_negative, display_sqrt,
log}`` metadata.

Under a point mesh (``tpinn_torch.sharding``) a loss built with
``mesh=mesh`` computes this rank's share of the global value, normalized by
the global count, so that the shares sum to it over the mesh; a loss
without one is computed whole on every rank and counted once.
"""

from __future__ import annotations

from typing import Callable

import torch


class Loss:
    """Generic named scalar loss: raw value = fn() / normalization."""

    display_sqrt = False
    # the point mesh whose ranks each hold a share of the loss; None: every
    # rank computes it whole (replicated, counted once)
    mesh = None

    def __init__(self, name: str, fn: Callable[[], torch.Tensor],
                 weight: float = 1.0, normalization: float = 1.0,
                 non_negative: bool = False):
        self.name = name
        self.fn = fn
        self.weight = float(weight)
        self.normalization = float(normalization)
        self.non_negative = bool(non_negative)

    def raw_value(self) -> torch.Tensor:
        return self.fn() / self.normalization

    def weighted_value(self) -> torch.Tensor:
        """The loss's term in the global objective: weight · raw value."""
        return self.weight * self.raw_value()

    def metadata(self) -> dict:
        return {
            "weight": self.weight,
            "non_negative": self.non_negative,
            "display_sqrt": self.display_sqrt,
        }

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r}, weight={self.weight})"


class LossMeanSquares(Loss):
    """Mean-of-squares residual loss: raw = mean((fn()/normalization)^2).

    ``point_residual`` (optional) is the pointwise form of the residual,
    ``(point_fn, args)`` with ``point_fn(params, *args_i) -> scalar`` for
    row i, as the reference's cases pass it for the Levenberg–Marquardt
    round's per-point Gram, which reads it.

    ``mesh``: ``fn`` returns this rank's rows of a batch padded to a
    multiple of the mesh size (``sharding.shard_pair``), and the raw value
    is their share of the global mean: Σ r² over the global padded count."""

    display_sqrt = True

    def __init__(self, name: str, fn: Callable[[], torch.Tensor],
                 weight: float = 1.0, normalization: float = 1.0,
                 point_residual=None, mesh=None):
        super().__init__(name, fn, weight=weight,
                         normalization=normalization, non_negative=True)
        self.point_residual = point_residual
        self.mesh = mesh

    def raw_value(self) -> torch.Tensor:
        r = self.fn() / self.normalization
        if self.mesh is None:
            return torch.mean(r * r)
        return torch.sum(r * r) / (r.numel() * self.mesh.size())


class PrecomputedMeanSquares(Loss):
    """A mean-of-squares loss whose ``fn`` already returns the MSE scalar;
    keeps LossMeanSquares' history metadata.  ``mesh``: ``fn`` returns this
    rank's share of the global MSE (a fused objective under a mesh)."""

    display_sqrt = True

    def __init__(self, name: str, fn: Callable[[], torch.Tensor],
                 weight: float = 1.0, mesh=None):
        super().__init__(name, fn, weight=weight, non_negative=True)
        self.mesh = mesh

    def raw_value(self) -> torch.Tensor:
        return self.fn()
