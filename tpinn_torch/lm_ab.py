"""A/B of the Levenberg–Marquardt round's two solvers on a resumed
Poiseuille polish: the host ``eigh`` loop against the device damping
ladder (the port's counterpart of scripts/lm_ladder_ab.py).

    python -m tpinn_torch.lm_ab --folder RUN [--iters 20] [--device cpu]

For each solver (``TPINN_LM_SOLVER=host`` and ``device``, one per
process) a copy of the Poiseuille run folder ``--folder`` is made (the
folder itself is never touched) and resumed twice by an LM round of
``ITERS`` iterations, each a process of ``tpinn_torch.cases.
poiseuille_flow --resume``: run 1 pays the process's start, the kernels'
build where no earlier process left it in ``.cache/tpinn_torch`` (the
port has no compilation cache beyond that) and the first calls; run 2
continues the same copy and is the steady number.  Each run reports the
round's wall from History_Loss.json and the final test losses, so the
solvers' agreement shows; the last line is one JSON object with the warm
seconds per iteration of each solver and their ratio.  The case runs at
the folder's options: ``simulation_options.txt`` beside the folder (in
its parent), copied beside the copy and passed to the case, where it
exists, else the case's defaults.  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

from tpinn_torch.campaign import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 20
OPTIONS_FILE = "simulation_options.txt"


def run(solver: str, folder: str, iters: int = ITERS, work_dir=None,
        device=None) -> dict:
    """Two LM rounds of ``iters`` iterations under ``TPINN_LM_SOLVER=
    solver`` on one copy of ``folder``; {"<solver>_run<k>": {wall_s,
    s_per_iter, test}} and the copy's path under "folder"."""
    work = tempfile.mkdtemp(prefix=f"lm_ab_{solver}_", dir=work_dir)
    folder = os.path.normpath(folder)
    dst = os.path.join(work, os.path.basename(folder))
    shutil.copytree(folder, dst)
    opts_file = os.path.join(os.path.dirname(folder), OPTIONS_FILE)
    options = (shutil.copy(opts_file, work) if os.path.exists(opts_file)
               else None)
    env = {**os.environ, "TPINN_LM_SOLVER": solver,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    extra = (["--device", str(device)] if device is not None else []) + (
        ["--options", options] if options else [])
    results = {"folder": dst}
    for rep in (1, 2):
        r = subprocess.run(
            [sys.executable, "-u", "-m", "tpinn_torch.cases.poiseuille_flow",
             "--base-dir", work, "--resume", dst, "--seed", "0",
             "--epochs", str(iters), "--second-round", "lm"] + extra,
            env=env, cwd=ROOT, capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-2000:])
            print(r.stderr[-2000:])
            raise SystemExit(f"{solver} rep {rep} failed")
        with open(os.path.join(dst, "History_Loss.json")) as f:
            h = json.load(f)
        wall = h["log_rounds"]["wall_time_seconds"][-1]
        test = {k: v["log"][-1] for k, v in h.get("losses_test", {}).items()}
        key = f"{solver}_run{rep}"
        results[key] = {"wall_s": wall, "s_per_iter": wall / iters,
                        "test": test}
        print(f"{key}: wall {wall:.1f}s = {wall / iters:.2f} s/iter, "
              f"test {{"
              + ", ".join(f"{k}: {v:.3e}" for k, v in test.items())
              + "}}", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--folder", required=True,
                    help="a saved Poiseuille run folder")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--work-dir", default=None,
                    help="where the copies go (default: the system's "
                         "temporary directory)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    name = backend(args.device)
    results = {}
    for solver in ("host", "device"):
        out = run(solver, args.folder, args.iters, args.work_dir,
                  args.device)
        out.pop("folder")
        results.update(out)
    warm_host = results["host_run2"]["s_per_iter"]
    warm_dev = results["device_run2"]["s_per_iter"]
    print(json.dumps({
        "config": f"Poiseuille {os.path.normpath(args.folder)} resume, "
                  f"{args.iters}-iter f64 LM on {name}",
        "host_warm_s_per_iter": round(warm_host, 3),
        "device_warm_s_per_iter": round(warm_dev, 3),
        "speedup": round(warm_host / warm_dev, 3),
        "all": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
