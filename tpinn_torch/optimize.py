"""Optimization driver: ``minimize(pb, strategy, optimizer, num_epochs)``.

Only the first-order round is ported: ``minimize(pb, "keras", Adam(lr),
num_epochs)`` runs full-batch Adam, logged as ``keras_Adam`` at iterations
0, 10, 20, ... and the final one.  Each step evaluates the global loss once
and differentiates it with ``torch.autograd.grad``; on the fused PDE path
that is one launch of the one-pass residual kernel per step.
"""

from __future__ import annotations

import time

import torch

from tpinn_torch.history import LOG_STRIDE
from tpinn_torch.optimizers import Adam
from tpinn_torch.problem import OptimizationProblem


def _log_point(pb: OptimizationProblem, iter_in_round: int) -> None:
    total, train, test = pb.eval_all()
    pb.history.append(iter_in_round, total, train, test)


def _log_iters(num_epochs: int, stride: int):
    """Iterations (within a round) at which the reference logs: 0, s, 2s,
    ... plus the final iteration when not already a multiple of s."""
    iters = list(range(0, num_epochs + 1, stride))
    if iters[-1] != num_epochs:
        iters.append(num_epochs)
    return iters


def _minimize_first_order(pb: OptimizationProblem, optimizer: Adam,
                          num_epochs: int, round_name: str):
    params = pb.params
    optimizer.init(params)

    pb.history.start_round(round_name)
    t0 = time.perf_counter()
    _log_point(pb, 0)
    done = 0
    for target in _log_iters(num_epochs, LOG_STRIDE)[1:]:
        for _ in range(target - done):
            loss = pb.loss_fn()
            grads = torch.autograd.grad(loss, params)
            optimizer.step(params, grads)
        done = target
        _log_point(pb, done)
    pb.history.add_wall_time(time.perf_counter() - t0)
    return params


def minimize(pb: OptimizationProblem, strategy: str, optimizer=None,
             num_epochs: int = 100):
    """Run one optimization round; appends to pb.history and updates the
    model's parameters in place."""
    strategy = strategy.lower()
    if strategy in ("keras", "adam"):
        optimizer = optimizer or Adam()
        if not isinstance(optimizer, Adam):
            raise TypeError(f"unsupported optimizer: {optimizer!r}")
        return _minimize_first_order(pb, optimizer, num_epochs,
                                     round_name=f"keras_{optimizer.name}")
    if strategy in ("scipy", "jax", "lbfgs"):
        raise NotImplementedError(
            f"strategy {strategy!r} (BFGS / L-BFGS / LM / host-scipy rounds) "
            "is not ported yet: ROADMAP.md, port queue 1, items 1 and 5")
    raise ValueError(f"unknown strategy {strategy!r}")
