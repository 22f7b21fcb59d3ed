"""The six-case campaign: every reference case trained in turn through its
case module's ``main``, and a table of the final test losses beside the
reference's published numbers (the port's counterpart of
scripts/run_all_cases.py).

    python -m tpinn_torch.campaign --epochs-scale 1.0 --second-round jax
    python -m tpinn_torch.campaign --only Poisson,Poiseuille_Flow --device cpu

Each case's ``main`` runs in this process with the case's epochs (scaled
by ``--epochs-scale``) as its second-round iterations and the reference
options otherwise (Adam 100 epochs first); ``--second-round`` picks the
round as the JAX package's campaign does ("jax" the on-device L-BFGS,
"jax-bfgs" the dense BFGS, "scipy" the cases' default).  Run folders and
data go to ``BASE/<Case>/`` (``--base-dir``, by default
``.cache/tpinn_torch/campaign``), never into ``examples/``.  After every
case the table is written to ``--out`` (by default
``docs/torch_runs/RESULTS.md``), its backend line naming the card and its
power limit as ``nvidia-smi`` gives them, or ``cpu``.  A case that raises
gets an ``ERROR`` row and the command exits 1.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import time
import traceback

import torch

from tpinn_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "docs", "torch_runs", "RESULTS.md")
BASE_DIR = os.path.join(ROOT, ".cache", "tpinn_torch", "campaign")

CASES = [
    # (name, case module, epochs at scale 1.0, reference final test losses)
    ("Poisson", "tpinn_torch.cases.poisson", 10000,
     {"fit": "~1e-7 (report, 10k ep)"}),
    ("Poisson_misto", "tpinn_torch.cases.poisson_misto", 7500,
     {"fit": "~1e-7 (report)"}),
    ("Poiseuille_Flow", "tpinn_torch.cases.poiseuille_flow", 10000,
     {"u_test": 1.20e-9, "v_test": 8.11e-11, "p_test": 1.90e-11}),
    ("Colliding_Flow", "tpinn_torch.cases.colliding_flow", 10000,
     {"u_test": 2.05e-7, "v_test": 4.02e-7, "p_test": 2.25e-4}),
    ("Cavity_Steady", "tpinn_torch.cases.cavity_steady", 10000,
     {"u_test": 5.01e-5, "v_test": 3.46e-4, "p_test": 6.90e-4}),
    ("Cavity_Unsteady", "tpinn_torch.cases.cavity_unsteady", 5000,
     {"u_test": "~1e-3 (report)", "v_test": "", "p_test": ""}),
    ("Coronary_Flow", "tpinn_torch.cases.coronary_flow_steady", 30000,
     {"u_test": 6.73e-5, "v_test": 6.47e-5, "p_test": 1.34e-5}),
]


def call_main(module: str, epochs: int, second_round: str, base: str,
              device):
    """The case's ``main`` with ``epochs`` second-round iterations into
    ``base``: the Poisson cases take them as ``epochs`` and write under
    ``out_dir``; the driver cases as ``epochs`` beside ``base_dir``."""
    mod = importlib.import_module(module)
    name = module.rsplit(".", 1)[1]
    if name in ("poisson", "poisson_misto"):
        return mod.main(epochs, out_dir=base, second_round=second_round,
                        device=device)
    if name in ("poiseuille_flow", "colliding_flow"):
        return mod.main(base, second_round=second_round, epochs=epochs,
                        device=device)
    return mod.main(epochs=epochs, base_dir=base, second_round=second_round,
                    device=device)


def run_case(name, module, epochs, second_round, device=None,
             base_dir=BASE_DIR):
    print(f"\n===== {name} ({epochs} epochs, second round {second_round}) "
          "=====", flush=True)
    base = os.path.join(base_dir, name)
    os.makedirs(base, exist_ok=True)
    t0 = time.time()
    result = call_main(module, epochs, second_round, base, device)
    wall = time.time() - t0
    pb = result[0] if isinstance(result, tuple) else result.pb
    finals = {k: v["log"][-1] for k, v in pb.history.losses_test.items()}
    print(f"{name}: {wall:.0f}s, finals {finals}", flush=True)
    return {"wall_seconds": round(wall, 1), "final_test_losses": finals,
            "loss_global": pb.history.loss_global[-1]}


def backend(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device type."""
    device = config.resolve_device(device)
    if device.type != "cuda":
        return device.type
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or "cuda"


def table(rows, second_round: str, epochs_scale: float,
          backend_name: str) -> list:
    """The table's lines, as the JAX package's campaign writes them."""
    lines = [
        "# RESULTS — tpinn six-case campaign",
        "",
        f"Backend: `{backend_name}` · second round: "
        f"`{second_round}` · epochs scale: {epochs_scale}",
        "",
        "| Case | Epochs | Final test losses (u/v/p) | Reference (BASELINE.md) "
        "| Wall (s) |",
        "|---|---|---|---|---|",
    ]
    for name, epochs, ref, res in rows:
        if "error" in res:
            lines.append(f"| {name} | {epochs} | ERROR: {res['error']} | | |")
            continue
        f = res["final_test_losses"]
        ours = " / ".join(f"{v:.2e}" for v in f.values())
        refs = " / ".join(str(v) for v in ref.values())
        lines.append(
            f"| {name} | {int(epochs * epochs_scale)} | {ours} | {refs} "
            f"| {res['wall_seconds']} |"
        )
    return lines


def write(out_path: str, lines) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs-scale", type=float, default=1.0)
    ap.add_argument("--second-round", default="jax",
                    choices=["jax", "jax-bfgs", "scipy"])
    ap.add_argument("--only", default=None,
                    help="comma-separated case names to run")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--base-dir", default=BASE_DIR,
                    help="run folders and data, one folder per case")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    device = config.resolve_device(args.device)
    backend_name = backend(device)

    only = set(args.only.split(",")) if args.only else None
    rows = []
    for name, module, epochs, ref in CASES:
        if only and name not in only:
            continue
        try:
            res = run_case(name, module, int(epochs * args.epochs_scale),
                           args.second_round, args.device, args.base_dir)
        except Exception as e:
            traceback.print_exc()
            res = {"error": str(e)}
        rows.append((name, epochs, ref, res))
        write(args.out, table(rows, args.second_round, args.epochs_scale,
                              backend_name))
    print("\nwrote", args.out)
    return 1 if any("error" in r[3] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
