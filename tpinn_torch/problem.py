"""OptimizationProblem: the model, its training and test losses, and the
history they are logged into (nisaba's ``ns.OptimizationProblem``).
Callbacks (history plots, checkpoints) are not ported yet."""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from tpinn_torch.history import History
from tpinn_torch.losses import Loss
from tpinn_torch.models import Model


class OptimizationProblem:
    def __init__(
        self,
        model: Model,
        losses: Sequence[Loss],
        losses_test: Union[Loss, Sequence[Loss], None] = None,
    ):
        if not isinstance(model, Model):
            raise TypeError("model must be a tpinn_torch Model")
        self.model = model
        self.losses: List[Loss] = list(losses)
        if losses_test is None:
            losses_test = []
        if isinstance(losses_test, Loss):
            losses_test = [losses_test]
        self.losses_test: List[Loss] = list(losses_test)
        self.history = History()
        self.history.register_losses(self.losses, self.losses_test)

    @property
    def params(self) -> List[torch.Tensor]:
        return self.model.flat_params()

    def loss_fn(self) -> torch.Tensor:
        """Global training loss Σ weight_i · raw_i at the current params."""
        total = 0.0
        for loss in self.losses:
            total = total + loss.weight * loss.raw_value()
        return total

    @torch.no_grad()
    def eval_all(self):
        """(loss_global, {train raw}, {test raw}) as Python floats, read
        from the device in one transfer."""
        names = [l.name for l in self.losses] + [l.name for l in self.losses_test]
        raws = [l.raw_value() for l in self.losses + self.losses_test]
        values = torch.stack([torch.as_tensor(r) for r in raws]).tolist()
        n_train = len(self.losses)
        train = dict(zip(names[:n_train], values[:n_train]))
        test = dict(zip(names[n_train:], values[n_train:]))
        total = 0.0
        for l in self.losses:
            total = total + l.weight * train[l.name]
        return total, train, test

    def save_history(self, path) -> None:
        self.history.save(path)
