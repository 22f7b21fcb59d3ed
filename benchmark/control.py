"""The readings that the correctness limits are set from, at a cell's own
size (the benchmark's runs do not run this):

* the control: the plain reference put in the program's place and
  computed in float32, the precision below the configuration's float64;
* planted faults: the reference with half of the PDE batch left out, the
  mean taken over the rest; on several ranks also one rank's share
  without the exchange between ranks (its rows over the global count).

Each is compared with the float64 reference by the numbers of
``benchmark.check``, on each seed, beside the program's own readings from
the run's set-up: the check steps and, where the timed round's kind has a
late state, the warm-up round's last iteration (for L-BFGS the control
there is the reference's two-loop and gradient in float32; the half batch
changes the gradient alone).  Both references are the round kinds' own
(``benchmark/rounds/``), found as a run finds them.  A state left unchanged
reads 1 in ``change_gap`` and needs no run.

    python3 -m benchmark.control --workload poiseuille_flow.adam.n4m \
        --seeds 11,12,13

prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from benchmark import check, harness, spec


def readings(cell_name: str, seed: int, device, cfg_override=None) -> dict:
    bench = spec.load_benchmark()
    cell = spec.cell(bench, cell_name)
    state = harness.setup_and_window(bench, cell, seed, 0.0, False, device,
                                     time.perf_counter(),
                                     cfg_override=cfg_override)
    harness.free_program(state, device)
    cfg, traffic, inputs = state["cfg"], state["traffic"], state["inputs"]
    theta0, late = state["theta0"], state["late"]
    out = {"workload": cell_name, "seed": seed}
    t0 = time.perf_counter()
    ref = harness.reference(state, device)
    late_ref = (harness.late_reference(state, device)
                if late is not None else None)
    out["reference_s"] = time.perf_counter() - t0
    out["program"] = check.gaps(state["prog_record"], ref, theta0)
    if late is not None:
        out["program"].update(check.late_gaps(
            state["round_kind"].late_program(late), late_ref))
    variants = {
        "control_float32": dict(dtype=torch.float32),
        "fault_half_batch": dict(n_rows=inputs["n_pde_total"] // 2),
    }
    if traffic["ranks"] > 1:
        variants["fault_no_exchange"] = dict(n_rows=cfg["n_pde"],
                                             n_mean=inputs["n_pde_total"])
    for name, kw in variants.items():
        rec = harness.reference(state, device, **kw)
        out[name] = check.gaps(rec, ref, theta0)
        if late is not None:
            out[name].update(check.late_gaps(
                harness.late_reference(state, device, **kw), late_ref))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
