"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, the metrics.

Each round is run by its kind (``benchmark/rounds/``), found by the name of
its traffic step's method: the harness names no method, so a cell whose
rounds are of another kind (Levenberg-Marquardt on the coronary case, the
dense BFGS round) comes in as new files alone.

Set-up, in order (``setup_s`` spans it from process start): the imports,
the round kinds of the traffic, the card, the inputs from the seed, the
kernel libraries (``kernel_load_s``), the problem through the program's
case builders (``build_s``), the check steps (the timed round's own call
for its first steps from the seed's weights, each step's loss, the first
gradient as the optimizer got it and the parameters after them recorded),
the traffic's set-up rounds, and a warm-up round of the timed round's call
(where the round kind has a late state, that round's is recorded: for
L-BFGS its ring of pairs is then past its wrap).  The window is one round
of the traffic's optimizer, run back to back as the program's rounds run (a
closed loop), ending in a synchronisation.  Its length: the traffic's
``nominal_step_s`` fixes the steps of a window of ``seconds`` (the same
work in every run of a seed), or else the warm-up's rate sizes it to last
about ``seconds`` (an Adam epoch's work is constant).  A traced run then
runs the same round again from the same parameters under the profiler, and
where the round kind has a per-iteration split, once more for it.  Then the
device's memory peak is read, the program's state is freed, and the
reference follows the check steps from the same inputs and works out the
late state's last iteration again.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Optional

import torch

from benchmark import check, spec

LOG_STRIDE = 10  # the program's rounds log every 10 steps


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference(state: dict, device, dtype=torch.float64, **fault) -> dict:
    """The reference's record of the check steps from the run's inputs, by
    the check step's round kind (``dtype``, ``fault``: a planted fault of
    the objective, for the control)."""
    cfg, inputs = state["cfg"], state["inputs"]
    objective = state["ref_mod"].Objective(cfg, inputs, device, dtype=dtype,
                                           **fault)
    step = state["traffic"]["check"]
    return state["check_kind"].reference(objective, inputs["params"], step,
                                         cfg)


def late_reference(state: dict, device, dtype=torch.float64,
                   **fault) -> dict:
    """The reference's record of the warm-up's last iteration, by the timed
    round's kind (``dtype``, ``fault`` as in ``reference``)."""
    return state["round_kind"].late_reference(
        state["cfg"], state["ref_mod"], state["inputs"], state["late"],
        device, dtype=dtype, **fault)


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
    # every round kind first: a method with no file fails before any work
    check_kind = spec.round_kind(traffic["check"]["method"])
    setup_kinds = [spec.round_kind(s["method"])
                   for s in traffic["setup_rounds"]]
    round_kind = spec.round_kind(traffic["round"]["method"])
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
    prog_record = check_kind.check_steps(pb, model, traffic["check"], lr)
    mark("check steps")
    for kind, step in zip(setup_kinds, traffic["setup_rounds"]):
        kind.run(pb, step, step["steps"], lr)
    _sync(device)
    mark("set-up rounds")

    step = traffic["round"]
    warm = traffic["warmup_steps"]
    _sync(device)
    t0 = time.perf_counter()
    round_kind.run(pb, step, warm, lr)
    _sync(device)
    per_step = traffic.get("nominal_step_s",
                           (time.perf_counter() - t0) / warm)
    late = (round_kind.late_state(pb, warm)
            if hasattr(round_kind, "late_state") else None)
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
    round_kind.run(pb, step, n, lr)
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
            round_kind.run(pb, step, n, lr)
            _sync(device)
        if hasattr(round_kind, "traced_split"):
            pb.set_flat(start)
            lbfgs_times = round_kind.traced_split(pb, step, n, lr)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    return {"cfg": cfg, "traffic": traffic, "ref_mod": ref_mod,
            "prog_mod": prog_mod, "check_kind": check_kind,
            "round_kind": round_kind, "inputs": inputs, "theta0": theta0,
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
    program's, for a round kind with a late state the warm-up's last
    iteration too, every number held to its limit, and a finite loss at the
    window's end."""
    ref = reference(state, device)
    values = check.gaps(state["prog_record"], ref, state["theta0"])
    if state["late"] is not None:
        values.update(check.late_gaps(
            state["round_kind"].late_program(state["late"]),
            late_reference(state, device)))
    ok, table = check.verdict(values, spec.limits(cell))
    return ok and math.isfinite(state["final_loss"]), table

