"""Cavity_Unsteady's polish scan: short Levenberg–Marquardt rounds with
raised loss weights, resumed from a saved run (the port's counterpart of
scripts/cavun_polish_scan.py).

Plain LM overfits the 5 % fit and boundary noise of the case: the training
loss falls while the test losses rise.  A physics-weighted polish raises
the PDE weights, so that the noise-free physics dominates the
least-squares system and the noisy fit and boundary rows act as
regularizers.  Each variant (``VARIANTS``) resumes a copy of ``--folder``
under ``--work-dir`` for ``--iters`` LM iterations, so the folder itself
is never touched, and prints every logged test row of the polish against
``TARGETS`` (``*`` where a target is met) and its best row, the one with
the smallest largest ratio to its target; then the scan's summary.
``--apply TAG`` runs variant TAG in place on ``--folder`` instead.

    python -m tpinn_torch.polish_scan --folder RUN --data-dir D \\
        [--variants pde10,pde100] [--iters 150] [--work-dir W]
    python -m tpinn_torch.polish_scan --folder RUN --data-dir D --apply pde10

``--data-dir`` holds the oracle's series (made there when missing);
``--draws FILE`` rebuilds a run trained from a draws file
(``tpinn_torch.witness``) instead of the port's draws at ``--seed``.  The
options are the case's resume's: ``simulation_options.txt`` beside the
folder (in its parent) where it exists, else the case's defaults; a scan
copies that file beside each copy of the folder.  The run goes in the
folder's own dtype (its checkpoint's), on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

from tpinn_torch import checkpoint, config, utils, witness
from tpinn_torch.cases import cavity_unsteady as cu
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import StandardNSDriver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK_DIR = os.path.join(ROOT, ".cache", "tpinn_torch", "polish_scan")
TARGETS = {"u_test": 4.58e-4, "v_test": 3.52e-4, "p_test": 1.23e-4}
VARIANTS = {
    "pde10": {"PDE_MASS": 1e2, "PDE_MOMU": 1e1, "PDE_MOMV": 1e1},
    "pde100": {"PDE_MASS": 1e3, "PDE_MOMU": 1e2, "PDE_MOMV": 1e2},
    "fit0": {"FIT": 1e-2},
    "plain": {},
}
OPTIONS_FILE = "simulation_options.txt"


def history_length(folder: str) -> int:
    """The number of logged points in a run folder's History_Loss.json."""
    with open(os.path.join(folder, "History_Loss.json")) as f:
        return len(json.load(f)["log"]["iter"])


def best_row(hist: dict, start: int, tag: str, overrides: dict,
             iters: int):
    """Print the logged test rows from index ``start`` on against
    ``TARGETS`` and the best of them; returns (max ratio, iteration, row)
    of the best."""
    it = hist["log"]["iter"]
    traj = {k: hist["losses_test"][k]["log"] for k in TARGETS}
    print(f"--- {tag}: overrides={overrides} iters={iters}")
    best = None
    for i in range(start, len(it)):
        row = {k: traj[k][i] for k in TARGETS}
        ratio = max(row[k] / TARGETS[k] for k in TARGETS)
        if best is None or ratio < best[0]:
            best = (ratio, it[i], row)
        marks = " ".join(
            f"{k}={row[k]:.3e}{'*' if row[k] <= TARGETS[k] else ' '}"
            for k in TARGETS
        )
        print(f"  iter {it[i]:>6} {marks} maxratio={ratio:.3f}")
    print(f"  BEST {tag}: maxratio={best[0]:.3f} @ iter {best[1]}: "
          + ", ".join(f"{k}={v:.3e}" for k, v in best[2].items()))
    return best


def polish(folder: str, data_dir: str, overrides: dict, iters: int,
           base_dir: str, device=None, draws=None,
           seed: int = 0) -> StandardNSDriver:
    """One LM round of ``iters`` iterations resuming ``folder`` in place,
    the case's weights updated by ``overrides``, in the folder's dtype (the
    global dtype put back afterwards), the options read from ``base_dir``
    as the case reads them; the artifacts written.  Returns the driver."""
    dtype = checkpoint.folder_dtype(folder)
    prev = config.get_dtype()
    config.set_dtype(dtype)
    try:
        return _polish(folder, data_dir, overrides, iters, base_dir, device,
                       draws, seed, dtype)
    finally:
        config.set_dtype(prev)


def _polish(folder, data_dir, overrides, iters, base_dir, device, draws,
            seed, dtype) -> StandardNSDriver:
    exact = cu.load_exact(data_dir, device=device)
    opts_file = os.path.join(base_dir, OPTIONS_FILE)
    opts = (SimulationOptions.from_file(opts_file)
            if os.path.exists(opts_file) else cu.default_options())
    opts.epochs = iters
    kw = dict(base_dir=base_dir, save_results=True, seed=seed,
              second_round="lm", device=device, dtype=dtype)
    spec = cu.build_spec(exact)
    spec = dataclasses.replace(spec,
                               weights={**spec.weights, **overrides})
    if draws is None:
        drv = StandardNSDriver(spec, opts, **kw)
    else:
        drv = witness.driver(witness.load_draws(draws), exact, spec=spec,
                             opts=opts, **kw)
    drv.train(resume_from=folder)
    if utils.has_module("matplotlib"):
        drv.save_artifacts(loss_groups=cu.LOSS_GROUPS)
    else:
        drv.save_experiment()
        drv.write_recap()
    return drv


def run_variant(folder: str, data_dir: str, tag: str, overrides: dict,
                iters: int, work_dir: str = WORK_DIR, **kw):
    """Variant ``tag`` on a copy of ``folder`` (and of the options file
    beside it) in ``work_dir``; returns its best row (``best_row``)."""
    work = os.path.join(work_dir, f"cavun_polish_{tag}")
    if os.path.exists(work):
        shutil.rmtree(work)
    os.makedirs(work)
    folder = os.path.normpath(folder)
    dst = os.path.join(work, os.path.basename(folder))
    shutil.copytree(folder, dst)
    opts_file = os.path.join(os.path.dirname(folder), OPTIONS_FILE)
    if os.path.exists(opts_file):
        shutil.copy(opts_file, work)
    start = history_length(dst)
    polish(dst, data_dir, overrides, iters, work, **kw)
    with open(os.path.join(dst, "History_Loss.json")) as f:
        hist = json.load(f)
    return best_row(hist, start, tag, overrides, iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--folder", required=True,
                    help="the saved Cavity_Unsteady run to polish")
    ap.add_argument("--data-dir", required=True,
                    help="the oracle's series (made there when missing)")
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--variants", default="pde10,pde100")
    ap.add_argument("--apply", metavar="TAG", default=None,
                    help="run variant TAG on --folder itself instead of "
                         "scanning copies")
    ap.add_argument("--work-dir", default=WORK_DIR)
    ap.add_argument("--draws", default=None,
                    help="the draws file the run was trained from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    kw = dict(device=config.resolve_device(args.device), draws=args.draws,
              seed=args.seed)
    if args.apply:
        folder = os.path.normpath(args.folder)
        drv = polish(folder, args.data_dir, VARIANTS[args.apply], args.iters,
                     os.path.dirname(folder), **kw)
        print("final test losses:", drv.final_test_losses())
        return 0
    results = {}
    for tag in args.variants.split(","):
        results[tag] = run_variant(args.folder, args.data_dir, tag,
                                   VARIANTS[tag], args.iters, args.work_dir,
                                   **kw)
    print("=== scan summary ===")
    for tag, best in results.items():
        ok = best[0] <= 1.0
        print(f"{tag}: maxratio {best[0]:.3f} @ iter {best[1]} "
              f"{'ALL TARGETS MET' if ok else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
