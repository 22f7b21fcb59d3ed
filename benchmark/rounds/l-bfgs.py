"""On-device L-BFGS rounds: the program's ``minimize`` with the step's
strategy ("jax": optax's L-BFGS, memory 50, with its zoom line search), and
the same algorithm in the plain reference.  The check also holds the state
the warm-up round ends in, whose ring of pairs is past its wrap."""

from __future__ import annotations

import torch

from benchmark.reference import optim
from benchmark.rounds import record


def run(pb, step: dict, n: int, lr: float, timed: bool = False) -> None:
    """One round of ``n`` iterations (``lr`` unused: the line search sets
    the step); ``timed``: the program records its iteration split
    (``pb.lbfgs_times``), synchronising at each boundary."""
    from tpinn_torch.optimize import minimize

    minimize(pb, step["strategy"], step["method"], num_epochs=n,
             timed=timed)


def check_steps(pb, model, step: dict, lr: float) -> dict:
    """The first ``step["steps"]`` iterations, the loss of every evaluation
    (line-search trials included) recorded; the first gradient is the first
    evaluation's."""
    losses = []
    first = {}
    inner = pb.flat_value_and_grad

    def recording(theta):
        value, grad = inner(theta)
        losses.append(value.detach().clone())
        first.setdefault("grad", grad.detach().clone())
        return value, grad

    pb.flat_value_and_grad = recording
    try:
        run(pb, step, step["steps"], lr)
    finally:
        del pb.flat_value_and_grad
    grad0 = [t for layer in pb.unravel(first["grad"])
             for t in (layer["kernel"], layer["bias"])]
    return record(losses, grad0, model)


def reference(objective, params, step: dict, cfg: dict) -> dict:
    return optim.lbfgs(objective, params, step["steps"])


def late_state(pb, count: int) -> dict:
    """The program's L-BFGS state as its round of ``count`` iterations left
    it (``pb.last_opt_state``, published at the round's last log point),
    on the host: the ring of pairs, the last iteration's parameters x_prev
    and gradient, the step size it took and the parameters it reached."""
    st = pb.last_opt_state
    lb = st["lbfgs"]
    host = lambda t: t.detach().to("cpu", torch.float64).clone()
    leaves = lambda flat: [host(t) for layer in pb.unravel(flat)
                           for t in (layer["kernel"], layer["bias"])]
    return {"count": count, "ring_dx": host(lb["diff_params_memory"]),
            "ring_dg": host(lb["diff_updates_memory"]),
            "x_prev": host(lb["params"]), "g_prev": host(lb["updates"]),
            "x_prev_leaves": leaves(lb["params"]),
            "g_prev_leaves": leaves(lb["updates"]),
            "eta": float(st["learning_rate"]), "x_now": host(pb.get_flat())}


def late_program(late: dict) -> dict:
    """The program's record of the warm-up's last iteration: the direction
    its step took and the gradient its state holds."""
    return {"direction": (late["x_now"] - late["x_prev"]) / late["eta"],
            "grad_leaves": late["g_prev_leaves"]}


def late_reference(cfg, ref_mod, inputs, late: dict, device,
                   dtype=torch.float64, **fault) -> dict:
    """The reference's record of the same iteration: its two-loop over the
    program's ring from the program's gradient, and its own gradient at
    x_prev (``fault``: a planted fault of the objective)."""
    cast = lambda t: t.to(device=device, dtype=dtype)
    direction = optim.ring_direction(
        cast(late["g_prev"]), cast(late["ring_dx"]), cast(late["ring_dg"]),
        late["count"]).cpu()
    objective = ref_mod.Objective(cfg, inputs, device, dtype=dtype, **fault)
    it = iter(late["x_prev_leaves"])
    params = [{k: cast(next(it)).requires_grad_(True)
               for k in ("kernel", "bias")}
              for _ in range(len(late["x_prev_leaves"]) // 2)]
    _, grads = objective.value_and_grad(params)
    return {"direction": direction,
            "grad_leaves": [g.detach().cpu() for g in grads]}


def traced_split(pb, step: dict, n: int, lr: float) -> list:
    """The iteration split of the window's round: it needs a
    synchronisation at each boundary, so the same round once more."""
    run(pb, step, n, lr, timed=True)
    return list(pb.lbfgs_times)
