"""First-order optimizers written in optax's operation order.

``torch.optim.Adam`` rounds differently (it folds the bias corrections into
the step size and adds eps to the corrected root), so float64 trajectories
would drift apart from the JAX package's.  These classes repeat optax's
transforms exactly:

* ``Adam``: ``scale_by_adam`` + ``scale(−lr)`` + ``apply_updates``,

      mu = (1 − b1) g + b1 mu;   nu = (1 − b2) g² + b2 nu;   t = t + 1
      u  = (mu / (1 − b1^t)) / (sqrt(nu / (1 − b2^t) + eps_root) + eps)
      p  = p + (−lr) u

* ``AdamW``: the same u, then ``add_decayed_weights``: u = u + wd · p,
  then p = p + (−lr) u;
* ``SGD``: ``trace`` when a momentum is given (m = g + decay · m; u = m, or
  g + decay · m with Nesterov), else u = g; then p = p + (−lr) u.

The learning rate is a number or a schedule: a callable of the step
count, counted from 0 at the first update, as
``optax.scale_by_learning_rate(schedule)`` counts it
(``cosine_decay_schedule`` ports optax's).  The parameters are updated in
place (no copy of the model per step).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

import torch

from tpinn_torch.profiling import span

Rate = Union[float, Callable[[int], float]]


class Optimizer:
    """A first-order optimizer: ``init(params)`` then ``step(params,
    grads)`` per iteration; ``name`` labels the round ``keras_<name>``."""

    name = "Optimizer"

    def __init__(self, learning_rate: Rate = 1e-2):
        self.learning_rate = (learning_rate if callable(learning_rate)
                              else float(learning_rate))
        self.step_count = 0

    def init(self, params: Sequence[torch.Tensor]) -> None:
        raise NotImplementedError

    def updates(self, params, grads) -> List[torch.Tensor]:
        """The optax-order update directions u (before the −lr scale)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        with span("adam.update"):
            rate = self.learning_rate
            if callable(rate):
                rate = float(rate(self.step_count))
            self.step_count += 1
            for p, u in zip(params, self.updates(params, grads)):
                p.add_(-rate * u)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` (exponent 1): init_value · ((1 −
    alpha) · c(k) + alpha) with c(k) = (1 + cos(π·min(k, decay_steps) /
    decay_steps)) / 2, in float64."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")
    steps = float(decay_steps)

    def schedule(count: int) -> float:
        count = min(float(count), steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / steps))
        decayed = (1 - alpha) * cosine_decay + alpha
        return init_value * decayed

    return schedule


class Adam(Optimizer):
    name = "Adam"

    def __init__(self, learning_rate: Rate = 1e-2, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
        super().__init__(learning_rate)
        self.b1, self.b2 = float(b1), float(b2)
        self.eps, self.eps_root = float(eps), float(eps_root)
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params: Sequence[torch.Tensor]) -> None:
        self.count = self.step_count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def updates(self, params, grads) -> List[torch.Tensor]:
        b1, b2 = self.b1, self.b2
        self.count += 1
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        out = []
        for i, g in enumerate(grads):
            mu = (1.0 - b1) * g + b1 * self.mu[i]
            nu = (1.0 - b2) * (g * g) + b2 * self.nu[i]
            self.mu[i], self.nu[i] = mu, nu
            out.append((mu / c1) / (torch.sqrt(nu / c2 + self.eps_root)
                                    + self.eps))
        return out


class AdamW(Adam):
    name = "AdamW"

    def __init__(self, learning_rate: Rate = 1e-2, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 weight_decay: float = 1e-4):
        super().__init__(learning_rate, b1, b2, eps, eps_root)
        self.weight_decay = float(weight_decay)

    def updates(self, params, grads) -> List[torch.Tensor]:
        return [u + self.weight_decay * p
                for u, p in zip(super().updates(params, grads), params)]


class SGD(Optimizer):
    name = "SGD"

    def __init__(self, learning_rate: Rate = 1e-2,
                 momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(learning_rate)
        self.momentum = None if momentum is None else float(momentum)
        self.nesterov = bool(nesterov)
        self.trace: List[torch.Tensor] = []

    def init(self, params: Sequence[torch.Tensor]) -> None:
        self.step_count = 0
        self.trace = [torch.zeros_like(p) for p in params]

    def updates(self, params, grads) -> List[torch.Tensor]:
        if self.momentum is None:
            return list(grads)
        d = self.momentum
        self.trace = [g + d * t for g, t in zip(grads, self.trace)]
        if self.nesterov:
            return [g + d * t for g, t in zip(grads, self.trace)]
        return list(self.trace)
