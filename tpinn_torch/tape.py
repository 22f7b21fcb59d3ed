"""Tape-style differentiation front end (nisaba's ``ns.GradientTape``).

The reference drivers open ``ns.GradientTape(persistent=True)``, call
``tape.watch(x)``, evaluate ``model(x)`` and then ask for input derivatives
of what they computed (``tens_style.gradient_scalar``, ``laplacian_scalar``,
...).  In PyTorch this is a real tape: ``watch`` makes the batch require
grad, so ``model(x)`` records a graph in x, and the operators
(:mod:`tpinn_torch.operators`) differentiate it with
``torch.autograd.grad(..., create_graph=True)``, so a loss built from them
stays differentiable in the parameters.

Grad mode is switched on inside the tape: the logged evaluations run under
``torch.no_grad`` and still need input derivatives.  On exit the tape
restores the grad mode and the ``requires_grad`` flag of every batch it
watched, so a batch that another loss also reads does not keep building
graphs in x.  ``persistent`` is accepted for API parity: derivatives can be
taken any number of times inside the tape.
"""

from __future__ import annotations

from typing import List

import torch


class GradientTape:
    """Context manager mirroring ``ns.GradientTape``."""

    def __init__(self, persistent: bool = False):
        self.persistent = persistent
        self._watched: List[torch.Tensor] = []
        self._grad_mode = None

    def watch(self, x: torch.Tensor) -> None:
        """Record derivatives with respect to ``x`` from here on."""
        if self._grad_mode is None:
            raise RuntimeError("GradientTape.watch outside the tape's `with`")
        if not x.requires_grad:
            x.requires_grad_(True)
            self._watched.append(x)

    def __enter__(self) -> "GradientTape":
        self._grad_mode = torch.enable_grad()
        self._grad_mode.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        for x in self._watched:
            x.requires_grad_(False)
        self._watched.clear()
        self._grad_mode.__exit__(exc_type, exc, tb)
        self._grad_mode = None
        return False
