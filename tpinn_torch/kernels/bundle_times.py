"""Kernel 5's call times on the card, from this checkout or another one.

    python tpinn_torch/kernels/bundle_times.py [--root DIR] [--lm] [--out FILE]

(run by path, so that ``tpinn_torch`` is not imported before --root is
read).  Imports ``tpinn_torch`` from DIR (default: the checkout this file
is in),
builds its kernels there, and times ``mlp_taylor_bundle`` on 2-32-32-32-3
(dim 2, seeded weights) at 1,000, 262,144 and 1,048,576 points in float64
and float32, as chip_smoke.py phase 10 does: CUDA events around 20
back-to-back calls at 1,000 points and around single calls above, the
median of 10 runs.  With ``--lm`` it also runs the Poiseuille
Levenberg–Marquardt round (10 iterations, float64) under
``TPINN_USE_PALLAS=1`` and prints the median split of iterations 2-10.
Prints one JSON line.  Running two checkouts in turns in one call (parent,
change, change, parent) compares them on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

SIZES = (1000, 262_144, 1_048_576)
WIDTHS = (2, 32, 32, 32, 3)


def _cuda_ms(fn, inner, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--lm", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bundle_times: no CUDA device")
    from tpinn_torch.kernels import mlp_bundle as mb

    if not os.path.abspath(mb.__file__).startswith(root + os.sep):
        raise SystemExit(f"bundle_times: imported {mb.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rec = {"root": root, "card": card, "ms": {}}
    for dtype in (torch.float64, torch.float32):
        for n in SIZES:
            rng = np.random.default_rng(7)
            params = []
            for a, b in zip(WIDTHS[:-1], WIDTHS[1:]):
                lim = (6.0 / (a + b)) ** 0.5
                params.append({
                    "kernel": torch.tensor(rng.uniform(-lim, lim, (a, b)),
                                           dtype=dtype, device=dev),
                    "bias": torch.tensor(rng.uniform(-0.1, 0.1, b),
                                         dtype=dtype, device=dev)})
            x = torch.tensor(rng.uniform(-1.0, 1.0, (n, 2)), dtype=dtype,
                             device=dev)
            ms = _cuda_ms(lambda: mb.mlp_taylor_bundle(params, x),
                          20 if n <= 10_000 else 1)
            rec["ms"][f"{str(dtype)[6:]} {n}"] = ms
    if args.lm:
        from tpinn_torch.cases import poiseuille_flow

        os.environ["TPINN_USE_PALLAS"] = "1"
        try:
            with tempfile.TemporaryDirectory() as td:
                drv = poiseuille_flow.main(td, adam_epochs=0,
                                           second_round="lm", epochs=10,
                                           device="cuda")
        finally:
            os.environ.pop("TPINN_USE_PALLAS", None)
        later = drv.pb.lm_times[1:]
        rec["lm_median_s"] = {k: float(np.median([t.get(k, 0.0)
                                                  for t in later]))
                              for k in sorted({k for t in later for k in t})}
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
