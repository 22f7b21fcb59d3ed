"""The benchmark of ``tpinn_torch``: one run of one cell.

    python3 -m benchmark.run --workload poiseuille_flow.adam.n4m --seed 7 \
        --seconds 20 --trace 0

reads the cell from BENCHMARK.json, runs it on the CUDA cards of this
machine (``chips`` of them; exit 2 and no result where there are fewer),
and prints as its last line one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number compared with its limit (also the last
lines of standard error).  A cell on several chips runs one process per
card over NCCL; this process is rank 0 and prints the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import datetime  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

# names that the process printing the result may not hold once the window
# has closed: JAX and the JAX package beside the port
FORBIDDEN = ("jax", "jaxlib", "flax", "tpinn")


class Run:
    """What the metric readers read (see ``benchmark.readers``)."""

    def __init__(self, state: dict, cell: dict, kind: str, traces, busy):
        self.cell, self.cfg = cell, state["cfg"]
        self.chips = int(cell["chips"])
        self.kind = kind
        self.unit = state["traffic"]["unit"]
        self.points = state["inputs"]["n_pde_total"]
        self.steps = state["steps"]
        self.setup_s, self.window_s = state["setup_s"], state["window_s"]
        self.build_s, self.kernel_load_s = (state["build_s"],
                                            state["kernel_load_s"])
        self.counts, self.lbfgs_times = state["counts"], state["lbfgs_times"]
        self.bwd_kernel = state["prog_mod"].BWD_KERNEL
        self.traces = traces
        # each rank's (device-busy seconds, traced window seconds), None
        # where no device operation was traced; the traced window ran the
        # untimed window's work again
        self.busy = busy


def forbidden_modules():
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (so ``tpinn_torch`` is not ``tpinn``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max if x > 0 else -sys.float_info.max
    return x


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_run(rank: int, world: int, port: int, args, t_start: float,
              device, bench: dict, cfg_override=None, plant=None):
    """One rank's set-up and window.  Under several ranks (NCCL on the
    cards, gloo on the CPU) each rank's (busy, traced window) seconds and
    memory peak are gathered on rank 0, which keeps its own trace.
    Returns (state, traces, busy, peaks) on rank 0, None on the others."""
    import torch

    from benchmark import harness, spec
    from benchmark.trace import Trace

    if plant is not None:
        plant()
    cell = spec.cell(bench, args.workload)
    mesh = None
    if world > 1:
        import torch.distributed as dist

        from tpinn_torch import sharding

        # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=300))
        mesh = sharding.point_mesh(world, devices=device.type)
    state = harness.setup_and_window(bench, cell, args.seed, args.seconds,
                                     bool(args.trace), device, t_start,
                                     mesh=mesh, cfg_override=cfg_override)
    prof = state.pop("prof")
    trace = Trace(prof) if prof is not None else None
    mine = (((trace.busy_s(), trace.window_s) if trace and trace.device
             else None), state["memory_peak"])
    if world == 1:
        return state, [trace] if trace else [], [mine[0]], [mine[1]]
    import torch.distributed as dist

    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return None
    return (state, [trace] if trace else [], [g[0] for g in gathered],
            [g[1] for g in gathered])


def _worker(rank: int, world: int, port: int, args, device_type: str,
            bench, cfg_override, plant) -> None:
    import torch

    device = torch.device("cuda", rank) if device_type == "cuda" else \
        torch.device(device_type)
    _rank_run(rank, world, port, args, time.perf_counter(), device, bench,
              cfg_override, plant)


def run(args, device=None, cfg_override=None, plant=None,
        bench=None) -> dict:
    """The result of one run (rank 0).  ``device``, ``cfg_override``,
    ``plant`` (a module-level function that every rank calls first, e.g.
    to break the timed path) and ``bench`` (in place of BENCHMARK.json)
    let a test drive a run on the CPU at a small size."""
    import torch

    from benchmark import harness, spec

    bench = bench or spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    world = int(spec.traffic(cell)["ranks"])
    device = device or torch.device("cuda", 0)
    procs = []
    port = _free_port() if world > 1 else 0
    if world > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_worker,
                             args=(r, world, port, args, device.type,
                                   bench, cfg_override, plant))
                 for r in range(1, world)]
        for p in procs:
            p.start()
    try:
        state, traces, shares, peaks = _rank_run(
            0, world, port, args, T_START, device, bench, cfg_override,
            plant)
    except BaseException:
        # the other ranks would wait in a collective for rank 0
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    runinfo = Run(state, cell, kind, traces, shares)
    metrics = {}
    for m in spec.metrics(bench, cell["name"], bool(args.trace)):
        value = spec.reader(m["name"]).read(runinfo)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = state["steps"]
    failed = 0 if math.isfinite(state["final_loss"]) else attempted
    harness.free_program(state, device)
    correct, table = harness.correctness(state, cell, device)
    device_block = {"platform": "gpu" if device.type == "cuda"
                    else device.type,
                    "kind": kind, "count": world,
                    "memory_peak_bytes": int(max(peaks))}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_block}
    if args.trace and traces and None not in shares:
        device_block["busy_s"] = sum(b for b, _ in shares) / len(shares)
        device_block["window_s"] = traces[0].window_s
        result["breakdown"] = {"device_ops": traces[0].device_ops(),
                               "idle_gaps": traces[0].idle_gaps()}
    print("set-up stages (s): " + json.dumps(state["stages"]),
          file=sys.stderr)
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in table.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec

    chips = int(spec.cell(spec.load_benchmark(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    result = run(args)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    limit = _power_limit()
    if limit:
        print(f"card: {limit}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"{name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
