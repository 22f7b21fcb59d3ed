"""Named, weighted losses (nisaba ``ns.Loss`` / ``ns.LossMeanSquares``).

* ``LossMeanSquares(name, fn, weight, normalization)``: ``fn`` returns a
  residual vector r; the logged raw value is ``mean((r/normalization)**2)``
  and the global objective receives ``weight * raw``.
* ``Loss``: a generic scalar loss.
* ``PrecomputedMeanSquares``: ``fn`` already returns the MSE scalar (the
  fused residual objective computes all three PDE MSEs at once).

History_Loss.json keeps per-loss ``{weight, non_negative, display_sqrt,
log}`` metadata.
"""

from __future__ import annotations

from typing import Callable

import torch


class Loss:
    """Generic named scalar loss: raw value = fn() / normalization."""

    display_sqrt = False

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
    round's per-point Gram.  It is stored; no ported round reads it yet."""

    display_sqrt = True

    def __init__(self, name: str, fn: Callable[[], torch.Tensor],
                 weight: float = 1.0, normalization: float = 1.0,
                 point_residual=None):
        super().__init__(name, fn, weight=weight,
                         normalization=normalization, non_negative=True)
        self.point_residual = point_residual

    def raw_value(self) -> torch.Tensor:
        r = self.fn() / self.normalization
        return torch.mean(r * r)


class PrecomputedMeanSquares(Loss):
    """A mean-of-squares loss whose ``fn`` already returns the MSE scalar;
    keeps LossMeanSquares' history metadata."""

    display_sqrt = True

    def __init__(self, name: str, fn: Callable[[], torch.Tensor],
                 weight: float = 1.0):
        super().__init__(name, fn, weight=weight, non_negative=True)

    def raw_value(self) -> torch.Tensor:
        return self.fn()
