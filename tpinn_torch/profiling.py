"""Profiling hooks: a one-line trace of training rounds, a wall-clock
section timer, and where an Adam epoch of the Poiseuille slice spends its
time on the card.

    with tpinn_torch.profiling.trace("/tmp/trace"):
        ns.minimize(pb, "jax", "L-BFGS", 1000)
    # -> open the .pt.trace.json in ui.perfetto.dev or TensorBoard

    python -m tpinn_torch.profiling [--epochs 20] [--out trace.json]

Builds the Poiseuille driver on the CUDA device (float64, the reference
options), runs warm-up steps, then traces ``--epochs`` Adam steps with
``torch.profiler`` (CPU and CUDA activities).  Prints the host wall time per
epoch, the device-busy time per epoch (the union of kernel intervals) and
its share of the wall, the kernel launches per epoch, and the kernels that
take the most device time.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time
from typing import Dict


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """``torch.profiler`` over the block (host activity, and the card's
    where one exists), written at its end into ``log_dir`` as a
    ``*.pt.trace.json`` Chrome trace, which Perfetto (ui.perfetto.dev) and
    TensorBoard open: the counterpart of ``jax.profiler.trace``.  With
    ``create_perfetto_link`` the file's path is printed.  Yields the
    profiler."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = set(os.listdir(log_dir))
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
    if create_perfetto_link:
        for name in sorted(set(os.listdir(log_dir)) - before):
            print(f"trace: {os.path.join(log_dir, name)} (open in "
                  "ui.perfetto.dev)")


class SectionTimer:
    """Accumulating named wall-clock sections.

    With ``sync`` each section ends by waiting for the card's queued work,
    so that device time is charged to the section that launched it.
    """

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.sync = sync

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                import torch

                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{name}: {total:.3f}s over {self.counts[name]} calls"
            for name, total in rows
        )


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--out", default=None, help="chrome trace output path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpinn_torch.cases.poiseuille_flow import build_spec, default_options
    from tpinn_torch.driver import StandardNSDriver
    from tpinn_torch.optimizers import Adam
    from tpinn_torch.problem import OptimizationProblem

    with tempfile.TemporaryDirectory() as td:
        drv = StandardNSDriver(build_spec(), default_options(), base_dir=td,
                               save_results=False, device=args.device)
    pb = OptimizationProblem(drv.model, drv.losses, drv.losses_test)
    params = pb.params
    adam = Adam(1e-2)
    adam.init(params)

    def epoch():
        loss = pb.loss_fn()
        grads = torch.autograd.grad(loss, params)
        adam.step(params, grads)

    for _ in range(5):
        epoch()
    sync = torch.cuda.synchronize if drv.device.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            epoch()
        sync()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    n = args.epochs
    if drv.device.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"wall per epoch: {1e3 * wall / n:.3f} ms; device busy per epoch: "
          f"{busy / n / 1e3:.3f} ms ({100 * busy / 1e6 / wall:.1f}% of wall); "
          f"device kernels per epoch: {len(kernels) / n:.1f}")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    port = [kv for kv in ranked if "residual_kernel" in kv[0]]
    for title, rows in (("top kernels", ranked[:12]), ("the port's kernels", port)):
        print(f"{title} by device time per epoch (us, launches):")
        for name, (t, c) in rows:
            print(f"  {t / n:9.2f} us  {c / n:5.1f}  {name[:90]}")
    if args.out:
        prof.export_chrome_trace(args.out)


if __name__ == "__main__":
    main()
