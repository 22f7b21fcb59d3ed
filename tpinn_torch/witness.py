"""The witness of Cavity_Unsteady's accuracy recipe: its first two stages
from given draws, to tell a fault of the port's training from the draw and
the precision.

    python -m tpinn_torch.witness oracle --draws FILE --data-dir D
    python -m tpinn_torch.witness run --draws FILE --dtype float32 \\
        --data-dir D --base-dir B --log-dir L --tag tpinn_f32
    python -m tpinn_torch.witness run --seed 1 --data-dir D --base-dir B \\
        --log-dir L --tag seed1

``oracle`` makes the cavity oracle's series in ``D`` (on the card; read
where it is there already) and holds it against the exact u, v, p that the
draws file carries at its Test indices: the largest difference over the
largest value, per field.

``run`` trains the recipe's stages 1-2 (``recipes.MANIFEST``'s
cavity_unsteady: Adam 100 and the cosine-decay Adam round of 10,000
epochs, then the on-device dense BFGS of 5,000 iterations resuming the
run folder) from the draws of ``--draws`` (a file of
tests/test_torch_cavity_witness.py: the JAX example's grid splits,
boundary points and values, t = 0 points, noisy fit targets and θ0) through
``StandardNSDriver.from_arrays``, or from the port's own draws at
``--seed``.  ``--dtype float32`` sets the global dtype first, as a float32
run does.  The report, ``LOG_DIR/summary_<tag>.json``, holds the test
losses and walls after each stage, the history's rounds and the run folder
(for ``tpinn_torch.polish_scan``).  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tpinn_torch import config
from tpinn_torch.cases import cavity_unsteady as cu
from tpinn_torch.driver import StandardNSDriver
from tpinn_torch.geometry import space_time_grid as _grid
from tpinn_torch.recipes import history_rounds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWS = os.path.join(ROOT, "docs", "torch_runs", "cavity_unsteady",
                     "witness", "tpinn_draws_seed0.npz")
# the recipe's stages 1-2 (recipes.MANIFEST["cavity_unsteady"])
STAGES = {"adam": 100, "cosine": 10000, "bfgs": 5000}
TARGETS = {"u_test": 4.58e-4, "v_test": 3.52e-4, "p_test": 1.23e-4}


def space_time_grid(dtype=torch.float64) -> torch.Tensor:
    """The case's space-time grid, as the driver builds it (t slowest)."""
    spec = cu.build_spec(None)
    (lx, ux), (ly, uy) = spec.extents
    n1, n2 = spec.grid_shape
    return _grid(*(torch.as_tensor(v, dtype=dtype) for v in (
        np.arange(0.0, spec.time_horizon, step=spec.dt),
        np.linspace(lx, ux, n1 + 1), np.linspace(ly, uy, n2 + 1))))


def arrays_from(flat: dict) -> dict:
    """``from_arrays``' keywords (the grid apart) from a draws file's flat
    arrays."""
    def pick(prefix):
        return {k[len(prefix):]: np.asarray(flat[k]) for k in flat
                if k.startswith(prefix)}

    bnd_val = {}
    for k, v in pick("bnd_val_").items():
        c, edge = k.split("_", 1)
        bnd_val.setdefault(int(c), {})[edge] = v
    n_layers = len({k.split("_")[1] for k in flat if k.startswith("param_")})
    return dict(
        idx_set=pick("idx_"), bnd_pts=pick("bnd_pts_"), bnd_val_num=bnd_val,
        sol_noise=[np.asarray(flat[f"sol_noise_{c}"]) for c in range(3)],
        ic_pts=np.asarray(flat["ic_pts"]),
        params=[{k: np.asarray(flat[f"param_{i}_{k}"])
                 for k in ("kernel", "bias")} for i in range(n_layers)])


def load_draws(path: str = DRAWS) -> dict:
    """A draws file as ``arrays_from``'s keywords, with its exact
    ``test`` (u, v, p) at the Test indices and its ``dtype``."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    out = arrays_from(flat)
    out["test"] = [flat[f"test_{c}"] for c in ("u", "v", "p")]
    out["dtype"] = str(flat["dtype"])
    return out


def driver(arrays: dict, exact, device=None, dtype=torch.float64,
           spec=None, opts=None, **kw) -> StandardNSDriver:
    """The case's driver (``spec``, ``opts``: by default the case's on
    ``exact``, the series) from ``arrays`` (``arrays_from``'s keywords)."""
    keep = ("idx_set", "bnd_pts", "bnd_val_num", "sol_noise", "ic_pts",
            "params")
    return StandardNSDriver.from_arrays(
        spec or cu.build_spec(exact), opts or cu.default_options(),
        dom_grid=space_time_grid(dtype), device=device, dtype=dtype,
        **{k: arrays[k] for k in keep}, **kw)


def oracle_gap(draws: dict, exact) -> dict:
    """max |port − tpinn| / max |tpinn| of u, v, p at the Test indices."""
    idx = np.asarray(draws["idx_set"]["Test"])
    return {name: float(np.max(np.abs(np.asarray(exact[c])[idx] - ref))
                        / np.max(np.abs(ref)))
            for c, (name, ref) in enumerate(zip("uvp", draws["test"]))}


def run(tag: str, data_dir: str, base_dir: str, log_dir: str,
        draws_path=None, seed: int = 0, dtype=torch.float64, device=None,
        stages=STAGES) -> dict:
    """Stages 1-2 of the recipe from the draws of ``draws_path`` (else the
    port's own at ``seed``) with ``dtype`` as the global dtype (put back
    afterwards); returns and writes the report."""
    prev = config.get_dtype()
    config.set_dtype(dtype)
    try:
        return _run(tag, data_dir, base_dir, log_dir, draws_path, seed,
                    dtype, device, stages)
    finally:
        config.set_dtype(prev)


def _run(tag, data_dir, base_dir, log_dir, draws_path, seed, dtype, device,
         stages) -> dict:
    exact = cu.load_exact(data_dir, device=device)
    arrays = load_draws(draws_path) if draws_path else None
    report = {"tag": tag, "draws": draws_path and os.path.relpath(
        draws_path, ROOT), "seed": seed, "dtype": str(dtype),
        "stages": stages, "targets": TARGETS}
    if arrays is not None:
        report["oracle_gap"] = oracle_gap(arrays, exact)

    def make(second_round, adam_epochs):
        kw = dict(base_dir=base_dir, save_results=True, seed=seed,
                  second_round=second_round, adam_epochs=adam_epochs)
        if arrays is None:
            return StandardNSDriver(cu.build_spec(exact), cu.default_options(),
                                    device=device, dtype=dtype, **kw)
        return driver(arrays, exact, device=device, dtype=dtype, **kw)

    os.makedirs(base_dir, exist_ok=True)
    t0 = time.time()
    d1 = make("adam", stages["adam"])
    d1.train(epochs=stages["cosine"])
    d1.save_experiment()
    report["stage1"] = {"wall_s": time.time() - t0,
                        "test": d1.final_test_losses()}
    print(f"{tag} stage 1: {report['stage1']}", flush=True)
    t0 = time.time()
    d2 = make("jax-bfgs", 0)
    d2.train(epochs=stages["bfgs"], resume_from=d1.folder)
    d2.save_experiment()
    d2.write_recap()
    report["stage2"] = {"wall_s": time.time() - t0,
                        "test": d2.final_test_losses(),
                        "counts": getattr(d2.pb, "bfgs_counts", None)}
    report["folder"] = d1.folder
    report["history"] = history_rounds(os.path.join(d1.folder,
                                                    "History_Loss.json"))
    report["met"] = all(report["stage2"]["test"][k] <= v
                        for k, v in TARGETS.items())
    print(f"{tag} stage 2: {report['stage2']}", flush=True)
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, f"summary_{tag}.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("oracle", "run"))
    ap.add_argument("--draws", default=None,
                    help="a draws file (default for 'oracle': the "
                         "committed one); 'run' without it takes the "
                         "port's own draws at --seed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--data-dir", required=True,
                    help="the oracle's series (made there when missing)")
    ap.add_argument("--base-dir", default=os.path.join(
        ROOT, ".cache", "tpinn_torch", "witness"))
    ap.add_argument("--log-dir", default=os.path.join(
        ROOT, "docs", "torch_runs", "cavity_unsteady", "witness"))
    ap.add_argument("--tag", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    device = config.resolve_device(args.device)
    if args.what == "oracle":
        t0 = time.time()
        exact = cu.load_exact(args.data_dir, device=device)
        gap = oracle_gap(load_draws(args.draws or DRAWS), exact)
        print(json.dumps({"oracle_s": time.time() - t0,
                          "oracle_gap": gap}))
        return 0 if max(gap.values()) <= 1e-9 else 1
    tag = args.tag or (f"tpinn_{args.dtype}" if args.draws
                       else f"seed{args.seed}_{args.dtype}")
    run(tag, args.data_dir, os.path.join(args.base_dir, tag), args.log_dir,
        draws_path=args.draws, seed=args.seed,
        dtype=getattr(torch, args.dtype), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
