"""Adam rounds: the program's first-order ``minimize`` with its Adam, and
Adam in optax's operation order in the plain reference."""

from __future__ import annotations

from benchmark.reference import optim
from benchmark.rounds import record


def run(pb, step: dict, n: int, lr: float, optimizer=None) -> None:
    """One round of ``n`` epochs with a fresh Adam at ``lr``, or with
    ``optimizer``."""
    from tpinn_torch.optimize import minimize
    from tpinn_torch.optimizers import Adam

    minimize(pb, step["strategy"], optimizer or Adam(lr), num_epochs=n)


def check_steps(pb, model, step: dict, lr: float) -> dict:
    """The first ``step["steps"]`` epochs, each epoch's loss recorded; the
    first gradient is Adam's first moment after one step over (1 - b1)."""
    from tpinn_torch.optimizers import Adam

    losses = []
    first = {}

    class FirstState(Adam):
        """Adam that keeps its first moment after the first step, which
        is (1 - b1) times the gradient that step got."""

        def step(self, params, grads):
            super().step(params, grads)
            if self.step_count == 1:
                first["mu"] = [m.clone() for m in self.mu]

    opt = FirstState(lr)
    inner = pb.loss_and_grads

    def recording(tensors):
        loss, grads = inner(tensors)
        losses.append(loss.detach().clone())
        return loss, grads

    pb.loss_and_grads = recording
    try:
        run(pb, step, step["steps"], lr, optimizer=opt)
    finally:
        del pb.loss_and_grads
    return record(losses, [m / (1.0 - opt.b1) for m in first["mu"]], model)


def reference(objective, params, step: dict, cfg: dict) -> dict:
    return optim.adam(objective, params, step["steps"], cfg["adam_lr"])
