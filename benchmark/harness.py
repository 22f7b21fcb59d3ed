"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, the metrics.

Set-up, in order (``setup_s`` spans it from process start): the imports,
the card, the inputs from the seed, the kernel libraries
(``kernel_load_s``), the problem through the program's case builders
(``build_s``), the check steps (the timed round's own call for its first
steps from the seed's weights, each step's loss, the first gradient as the
optimizer got it and the parameters after them recorded), the traffic's
set-up rounds, and a warm-up round of the timed round's call (for L-BFGS
its last iteration's state is recorded: its ring of pairs is then past its
wrap).  The window is one round of the traffic's optimizer, run back to
back as the program's rounds run (a closed loop), ending in a
synchronisation.  Its length: the traffic's ``nominal_step_s`` fixes the
steps of a window of ``seconds`` (the same work in every run of a seed),
or else the warm-up's rate sizes it to last about ``seconds`` (an Adam
epoch's work is constant).  A traced run then runs the same round again
from the same parameters under the profiler, and for L-BFGS once more
with the program's per-iteration spans on.  Then the device's memory peak
is read, the program's state is freed, and the reference follows the
check steps from the same inputs and works out the warm-up's last
direction and gradient again.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Optional

import torch

from benchmark import check, spec
from benchmark.reference import optim

LOG_STRIDE = 10  # the program's rounds log every 10 steps


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _round(pb, step: dict, n: int, lr: float, optimizer=None,
           timed: bool = False):
    """One round of the program's ``minimize`` for ``n`` steps."""
    from tpinn_torch.optimize import minimize
    from tpinn_torch.optimizers import Adam

    if step["method"] == "Adam":
        minimize(pb, step["strategy"], optimizer or Adam(lr), num_epochs=n)
    else:
        minimize(pb, step["strategy"], step["method"], num_epochs=n,
                 timed=timed)


def _check_steps(pb, model, step: dict, lr: float) -> dict:
    """The timed round's call for its first ``step["steps"]``, recording each
    step's loss (each evaluation's, for a line-search round), the first
    gradient as the optimizer got it, and the parameters after them."""
    from tpinn_torch.optimizers import Adam

    losses = []
    first = {}
    if step["method"] == "Adam":
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
            _round(pb, step, step["steps"], lr, optimizer=opt)
        finally:
            del pb.loss_and_grads
        grad0 = [m / (1.0 - opt.b1) for m in first["mu"]]
    else:
        inner = pb.flat_value_and_grad

        def recording(theta):
            value, grad = inner(theta)
            losses.append(value.detach().clone())
            first.setdefault("grad", grad.detach().clone())
            return value, grad

        pb.flat_value_and_grad = recording
        try:
            _round(pb, step, step["steps"], lr)
        finally:
            del pb.flat_value_and_grad
        grad0 = [t for layer in pb.unravel(first["grad"])
                 for t in (layer["kernel"], layer["bias"])]
    return {"losses": torch.stack(losses).tolist(),
            "grad0": [g.detach().cpu() for g in grad0],
            "final": [t.detach().cpu().clone() for t in model.flat_params()]}


def _reference(cfg, traffic, ref_mod, inputs, device, dtype=torch.float64,
               **fault) -> dict:
    """The reference's record of the check steps from the same inputs
    (``fault``: a planted fault of the objective, for the control)."""
    objective = ref_mod.Objective(cfg, inputs, device, dtype=dtype, **fault)
    step = traffic["check"]
    if step["method"] == "Adam":
        return optim.adam(objective, inputs["params"], step["steps"],
                          cfg["adam_lr"])
    return optim.lbfgs(objective, inputs["params"], step["steps"])


def _late_state(pb, count: int) -> dict:
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


def _late_program(late: dict) -> dict:
    """The program's record of the warm-up's last iteration: the direction
    its step took and the gradient its state holds."""
    return {"direction": (late["x_now"] - late["x_prev"]) / late["eta"],
            "grad_leaves": late["g_prev_leaves"]}


def _late_reference(cfg, ref_mod, inputs, late: dict, device,
                    dtype=torch.float64, **fault) -> dict:
    """The reference's record of the same iteration: its two-loop over the
    program's ring from the program's gradient, and its own gradient at
    x_prev (``dtype``, ``fault`` as in ``_reference``)."""
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


def setup_and_window(bench: dict, cell: dict, seed: int, seconds: float,
                     trace: bool, device, t_start: float, mesh=None,
                     cfg_override: Optional[dict] = None) -> dict:
    """Everything up to the reference, in this process (one rank); returns
    what the reference and the readers need."""
    stages = {"imports": time.perf_counter() - t_start}
    lap = time.perf_counter()

    def mark(name):
        nonlocal lap
        now = time.perf_counter()
        stages[name] = now - lap
        lap = now

    cfg = dict(spec.config(bench, cell), **(cfg_override or {}))
    traffic = spec.traffic(cell)
    prog_mod, ref_mod = spec.problem_modules(cfg)
    lr = cfg["adam_lr"]
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
    mark("card")
    inputs = ref_mod.make_inputs(cfg, seed, traffic["ranks"])
    mark("inputs")

    kernel_load_s = None
    if device.type == "cuda":
        from tpinn_torch.kernels import build

        t0 = time.perf_counter()
        for source in prog_mod.KERNEL_SOURCES:
            build.library(source)
        kernel_load_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    pb, model = prog_mod.build(cfg, inputs, device, mesh=mesh)
    _sync(device)
    build_s = time.perf_counter() - t0

    mark("kernels and build")
    theta0 = [t.detach().cpu().clone() for t in model.flat_params()]
    prog_record = _check_steps(pb, model, traffic["check"], lr)
    mark("check steps")
    for step in traffic["setup_rounds"]:
        _round(pb, step, step["steps"], lr)
    _sync(device)
    mark("set-up rounds")

    step = traffic["round"]
    warm = traffic["warmup_steps"]
    _sync(device)
    t0 = time.perf_counter()
    _round(pb, step, warm, lr)
    _sync(device)
    per_step = traffic.get("nominal_step_s",
                           (time.perf_counter() - t0) / warm)
    late = _late_state(pb, warm) if step["method"] == "L-BFGS" else None
    mark("warm-up")
    n = max(LOG_STRIDE, LOG_STRIDE * round(seconds / per_step / LOG_STRIDE))

    if mesh is not None:
        # every rank runs the window with the same length
        t = torch.tensor([n], device=device)
        torch.distributed.broadcast(t, 0)
        n = int(t.item())

    start = pb.get_flat().clone()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    _round(pb, step, n, lr)
    _sync(device)
    window_s = time.perf_counter() - t0

    final_loss = pb.history.loss_global[-1]
    counts = dict(getattr(pb, "lbfgs_counts", None) or {})
    prof = lbfgs_times = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # the window's round again, from the same parameters, so the same
        # work: the trace's device time is read against the untraced
        # window, whose host the trace does not slow.  On the card the
        # device's operations and the CUDA runtime calls alone: recording
        # every host operation as well slowed a traced Adam window from 31
        # to 39 ms an epoch on a busy host
        pb.set_flat(start)
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if device.type == "cuda"
                                   else ProfilerActivity.CPU])
        with prof:
            _round(pb, step, n, lr)
            _sync(device)
        if step["method"] == "L-BFGS":
            # the iteration split needs a synchronisation at each boundary:
            # the same round once more
            pb.set_flat(start)
            _round(pb, step, n, lr, timed=True)
            lbfgs_times = list(pb.lbfgs_times)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    return {"cfg": cfg, "traffic": traffic, "ref_mod": ref_mod,
            "prog_mod": prog_mod, "inputs": inputs, "theta0": theta0,
            "prog_record": prog_record, "late": late, "pb": pb,
            "model": model,
            "setup_s": setup_s, "window_s": window_s, "steps": n,
            "final_loss": final_loss, "counts": counts,
            "lbfgs_times": lbfgs_times, "memory_peak": memory_peak,
            "build_s": build_s, "kernel_load_s": kernel_load_s,
            "prof": prof, "device": device, "stages": stages}


def free_program(state: dict, device) -> None:
    """Drop the program's problem and model, so that the reference finds
    the card's memory."""
    state.pop("pb", None)
    state.pop("model", None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def correctness(state: dict, cell: dict, device):
    """(correct, table) of the run: the reference's check steps against the
    program's, for L-BFGS the warm-up's last iteration too, every number
    held to its limit, and a finite loss at the window's end."""
    args = (state["cfg"], state["ref_mod"], state["inputs"])
    ref = _reference(args[0], state["traffic"], *args[1:], device)
    values = check.gaps(state["prog_record"], ref, state["theta0"])
    if state["late"] is not None:
        values.update(check.late_gaps(
            _late_program(state["late"]),
            _late_reference(*args, state["late"], device)))
    ok, table = check.verdict(values, spec.limits(cell))
    return ok and math.isfinite(state["final_loss"]), table

