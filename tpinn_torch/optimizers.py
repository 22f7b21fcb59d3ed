"""Adam written in optax's operation order.

``torch.optim.Adam`` rounds differently (it folds the bias corrections into
the step size and adds eps to the corrected root), so float64 trajectories
would drift apart from the JAX package's.  This class repeats optax's
``scale_by_adam`` + ``scale(-lr)`` + ``apply_updates`` exactly:

    mu = (1 − b1) g + b1 mu;   nu = (1 − b2) g² + b2 nu;   t = t + 1
    u  = (mu / (1 − b1^t)) / (sqrt(nu / (1 − b2^t) + eps_root) + eps)
    p  = p + (−lr) u

The parameters are updated in place (no copy of the model per step).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class Adam:
    name = "Adam"

    def __init__(self, learning_rate: float = 1e-2, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2 = float(b1), float(b2)
        self.eps, self.eps_root = float(eps), float(eps_root)
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params: Sequence[torch.Tensor]) -> None:
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        self.count += 1
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        for i, (p, g) in enumerate(zip(params, grads)):
            mu = (1.0 - b1) * g + b1 * self.mu[i]
            nu = (1.0 - b2) * (g * g) + b2 * self.nu[i]
            self.mu[i], self.nu[i] = mu, nu
            u = (mu / c1) / (torch.sqrt(nu / c2 + self.eps_root) + self.eps)
            p.add_(-self.learning_rate * u)
