"""The optimizers of the timed rounds, plainly, for the first steps that the
correctness check follows: Adam in optax's operation order, and optax's
L-BFGS (memory 50, the two-loop product) with its zoom line search
(Nocedal and Wright, Algorithms 3.5 and 3.6, a first trial of 1, at most 30
trials).  ``ring_direction`` works out L-BFGS's direction from a ring of
difference pairs past its wrap, for the check of a round's late state.

Each returns a record of what the program's run is compared on: the loss
of every step (for L-BFGS, of every evaluation, line-search trials
included), the gradient at the start, and the parameters at the end.
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch

from benchmark.reference import mlp


def _leaves_like(params, dtype, device):
    return [{k: torch.as_tensor(p[k]).to(device=device, dtype=dtype)
             .detach().clone().requires_grad_(True) for k in ("kernel", "bias")}
            for p in params]


def adam(objective, params0, steps: int, lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> dict:
    """``steps`` full-batch Adam steps from ``params0``:
    mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu;
    p = p - lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)."""
    params = _leaves_like(params0, objective.dtype, objective.device)
    leaves = mlp.leaves(params)
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    losses, grad0 = [], None
    for t in range(1, steps + 1):
        loss, grads = objective.value_and_grad(params)
        losses.append(float(loss))
        if grad0 is None:
            grad0 = [g.detach().clone() for g in grads]
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(leaves, grads)):
                mu[i] = (1.0 - b1) * g + b1 * mu[i]
                nu[i] = (1.0 - b2) * (g * g) + b2 * nu[i]
                u = (mu[i] / (1.0 - b1 ** t)) / (
                    torch.sqrt(nu[i] / (1.0 - b2 ** t)) + eps)
                p -= lr * u
    return {"losses": losses, "grad0": grad0,
            "final": [t.detach().clone() for t in leaves]}


class _Search:
    """optax's zoom line search along d from x, on host floats; ``vg(eta)``
    -> (value, grad vector, slope)."""

    c1, c2, approx_rtol, increase, threshold = 1e-4, 0.9, 1e-6, 2.0, 1e-5

    def __init__(self, vg: Callable, f0: float, g0, slope0: float,
                 max_steps: int = 30):
        self.vg, self.f0, self.slope0 = vg, f0, slope0
        self.max_steps = max_steps
        self.safe = (0.0, f0, g0)

    def dec_error(self, eta, v, s):
        """The Armijo error, or the approximate decrease error of Hager and
        Zhang where smaller; 0 where met, inf where not a number."""
        err = v - self.f0 - self.c1 * eta * self.slope0
        approx = max(s - (2 * self.c1 - 1.0) * self.slope0,
                     v - self.f0 - self.approx_rtol * abs(self.f0))
        if math.isnan(err) or math.isnan(approx):
            return math.inf
        return max(min(approx, err), 0.0)

    def curv_error(self, s):
        e = abs(s) - self.c2 * abs(self.slope0)
        return math.inf if math.isnan(e) else max(e, 0.0)

    @staticmethod
    def cubicmin(a, fa, fpa, b, fb, c, fc):
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        v0, v1 = fb - fa - fpa * db, fc - fa - fpa * dc
        try:
            A = (dc * dc * v0 - db * db * v1) / denom
            B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
            rad = B * B - 3.0 * A * fpa
            return a + (-B + math.sqrt(rad)) / (3.0 * A)
        except (ZeroDivisionError, ValueError, OverflowError):
            return math.nan

    @staticmethod
    def quadmin(a, fa, fpa, b, fb):
        db = b - a
        try:
            B = (fb - fa - fpa * db) / (db * db)
            return a - fpa / (2.0 * B)
        except (ZeroDivisionError, OverflowError):
            return math.nan

    def run(self):
        """(eta, value, grad) of the accepted step, else of the best step
        with sufficient decrease, else of the last trial."""
        prev = (0.0, self.f0, self.slope0)  # (eta, value, slope)
        low = high = cref = prev
        interval, count = False, 0
        while True:
            if not interval:
                eta = 1.0 if count == 0 else self.increase * prev[0]
                v, g, s = self.vg(eta)
                dec, curv = self.dec_error(eta, v, s), self.curv_error(s)
                if dec <= 0.0:
                    self.safe = (eta, v, g)
                set_high = dec > 0.0 or (count > 0 and v >= prev[1])
                set_low = s >= 0.0 and not set_high
                low, high = ((eta, v, s), prev) if set_low else (prev, (eta, v, s))
                cref = low
                interval = set_high or set_low or max(dec, curv) <= 0.0
                too_small = False
            else:
                delta = abs(high[0] - low[0])
                left, right = min(high[0], low[0]), max(high[0], low[0])
                too_small = delta <= self.threshold
                mc = self.cubicmin(*low, high[0], high[1], cref[0], cref[1])
                mq = self.quadmin(*low, high[0], high[1])
                if left + 0.2 * delta < mc < right - 0.2 * delta:
                    eta = mc
                elif left + 0.1 * delta < mq < right - 0.1 * delta:
                    eta = mq
                else:
                    eta = (low[0] + high[0]) / 2.0
                v, g, s = self.vg(eta)
                dec, curv = self.dec_error(eta, v, s), self.curv_error(s)
                if dec <= 0.0 and v < self.safe[1]:
                    self.safe = (eta, v, g)
                to_middle = dec > 0.0 or v >= low[1]
                to_low = s * (high[0] - low[0]) >= 0.0 and not to_middle
                cref = high if (to_middle or to_low) else low
                new_high = (eta, v, s) if to_middle else (low if to_low else high)
                if not to_middle:
                    low = (eta, v, s)
                high = new_high
            count += 1
            done = max(dec, curv) <= 0.0
            failed = not done and (count >= self.max_steps
                                   or (too_small and self.safe[0] > 0.0))
            prev = (eta, v, s)
            if done:
                return eta, v, g
            if failed:
                if self.safe[0] > 0.0 or math.isinf(dec):
                    return self.safe
                return eta, v, g


def two_loop(grad, pairs, scale: float):
    """The two-loop product of L-BFGS's inverse-Hessian estimate with
    ``grad``: ``pairs`` (dx, dg, 1 / <dg, dx>) oldest first, the identity
    scaled by ``scale``."""
    q, alphas = grad.clone(), []
    for dx, dg, w in reversed(pairs):
        a = w * float(torch.dot(dx, q))
        alphas.append(a)
        q = q - a * dg
    q = scale * q
    for (dx, dg, w), a in zip(pairs, reversed(alphas)):
        b = w * float(torch.dot(dg, q))
        q = q + (a - b) * dx
    return q


def ring_direction(grad, ring_dx, ring_dg, count: int, memory: int = 50):
    """The direction of optax's L-BFGS at its ``count``-th update (counted
    from 1) from a ring of ``memory`` slots: the pair of update c >= 1 sits
    in slot (c - 1) % memory, so the ring then holds the pairs of updates
    max(1, count - memory) .. count - 1, the newest scaling the identity.
    The weights and the scale are worked out from the pairs."""
    pairs = []
    for c in range(max(1, count - memory), count):
        dx, dg = ring_dx[(c - 1) % memory], ring_dg[(c - 1) % memory]
        vdot = float(torch.dot(dg, dx))
        pairs.append((dx, dg, 0.0 if vdot == 0.0 else 1.0 / vdot))
    if pairs:
        dx, dg, _ = pairs[-1]
        den = float(torch.dot(dg, dg))
        scale = float(torch.dot(dg, dx)) / den if den > 0.0 else 1.0
    else:
        scale = min(1.0 / float(torch.linalg.norm(grad)), 1.0)
    return -two_loop(grad, pairs, scale)


def lbfgs(objective, params0, steps: int, memory: int = 50) -> dict:
    """``steps`` iterations of optax's L-BFGS from ``params0`` on the flat
    parameter vector (kernel_0, bias_0, ...)."""
    params = _leaves_like(params0, objective.dtype, objective.device)
    shapes = [t.shape for t in mlp.leaves(params)]
    losses: List[float] = []

    def unflat(theta):
        out, off, it = [], 0, iter(shapes)
        for _ in params:
            layer = {}
            for key in ("kernel", "bias"):
                shape = next(it)
                n = math.prod(shape)
                layer[key] = (theta[off:off + n].reshape(shape).detach()
                              .clone().requires_grad_(True))
                off += n
            out.append(layer)
        return out

    def vg(theta):
        value, grads = objective.value_and_grad(unflat(theta))
        losses.append(float(value))
        return float(value), torch.cat([g.reshape(-1) for g in grads])

    x = torch.cat([t.detach().reshape(-1) for t in mlp.leaves(params)])
    value, grad, grad0 = math.inf, None, None
    pairs = []  # (dx, dg, 1 / <dg, dx>), oldest first
    prev_x = prev_g = None
    for _ in range(steps):
        # a step that ended outside the domain (or the first) evaluates anew
        if not math.isfinite(value):
            value, grad = vg(x)
        if grad0 is None:
            grad0 = unflat(grad)
        if prev_x is None:
            scale = min(1.0 / float(torch.linalg.norm(grad)), 1.0)
        else:
            dx, dg = x - prev_x, grad - prev_g
            vdot = float(torch.dot(dg, dx))
            pairs = (pairs + [(dx, dg, 0.0 if vdot == 0.0 else 1.0 / vdot)])
            pairs = pairs[-memory:]
            den = float(torch.dot(dg, dg))
            scale = vdot / den if den > 0.0 else 1.0
        d = -two_loop(grad, pairs, scale)
        prev_x, prev_g = x, grad

        def on_line(eta, x=x, d=d):
            v, g = vg(x + eta * d)
            return v, g, float(torch.dot(g, d))

        search = _Search(on_line, value, grad, float(torch.dot(grad, d)))
        eta, value, grad = search.run()
        x = x + eta * d
    return {"losses": losses, "grad0": mlp.leaves(grad0),
            "final": mlp.leaves(unflat(x))}
