"""Diagnostics of a coronary run's loss floor at its checkpointed state (the
port's counterpart of scripts/diag_coronary_floor.py and
scripts/diag_lm_mu_scan.py).

    python -m tpinn_torch.diagnostics floor --folder RUN \\
        [--refine 1 --noise-bnd 0.01] [--base-dir B] [--device cpu]
    python -m tpinn_torch.diagnostics mu-scan --folder RUN ...

Both rebuild the run's objective as the coronary case resumes it
(``coronary_flow_steady.problem``: seed 0's draws, ``--refine``, the
boundary noise, the folder's weights, checkpoint and history; the data and
mesh from ``--base-dir``, by default the folder's parent), in the folder's
own dtype (its checkpoint's: a float32 run is diagnosed in float32).

* ``floor``: the loss, ‖grad‖ and max |g|; the loss along −grad/‖grad‖ at
  steps 1e-1 … 1e-6; the training and test losses, loss by loss.
* ``mu-scan``: the residual Jacobian by chunked forward-mode products
  (``problem.JAC_CHUNK`` tangents per block), the residuals linearized at
  the float32 split θ = hi + lo (r(hi) and J(hi)·lo kept apart), JᵀJ and
  Jᵀr on the host in float64 and ``eigh`` of JᵀJ; then for each μ of the
  damping ladder 1e-3 … 1e12 the damped step δ(μ) = −V·(c/(w + λ)),
  λ = μ·w_max, and: |δ|, how many float32 parameters it changes
  (hi_chg), the loss change the split paired test sees (df_split), the
  model's predicted change (df_pred = 2·cᵀs + sᵀ(w·s)) and their ratio.

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from tpinn_torch import checkpoint, config
from tpinn_torch.cases import coronary_flow_steady as cfs
from tpinn_torch.problem import JAC_CHUNK

STEPS = [1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6]
MUS = [10.0 ** k for k in range(-3, 13)]


def resumed_problem(folder: str, base_dir=None, refine: int = 0,
                    noise_bnd=None, device=None):
    """The coronary run in ``folder`` (seed 0's draws) resumed, in its own
    dtype (the global dtype put back afterwards): pb."""
    prev = config.get_dtype()
    config.set_dtype(checkpoint.folder_dtype(folder))
    try:
        base = base_dir or os.path.dirname(os.path.normpath(folder))
        return cfs.problem(base_dir=base, seed=0, resume_from=folder,
                           refine=refine, noise_bnd=noise_bnd,
                           device=device)[0]
    finally:
        config.set_dtype(prev)


def _loss_at(pb, theta: torch.Tensor) -> float:
    pb.set_flat(theta)
    with torch.no_grad():
        return float(pb.loss_fn())


def floor(pb, verbose: bool = True) -> dict:
    """The loss, its gradient and the descent probe at ``pb``'s θ."""
    theta0 = pb.get_flat()
    val, grad = pb.flat_value_and_grad(theta0)
    val, gnorm = float(val), float(torch.linalg.norm(grad))
    gmax = float(torch.max(torch.abs(grad)))
    out = {"dtype": str(theta0.dtype), "P": int(theta0.shape[0]),
           "loss": val, "grad_norm": gnorm, "grad_max": gmax, "probe": {}}
    say = print if verbose else (lambda *a, **k: None)
    say("device:", theta0.device, "dtype:", theta0.dtype, "P:", out["P"])
    say(f"loss = {val:.8e}")
    say(f"||grad|| = {gnorm:.6e}  max|g| = {gmax:.3e}")
    g = grad / (gnorm + 1e-30)
    for s in STEPS:
        f = _loss_at(pb, theta0 - s * g)
        out["probe"][s] = f
        say(f"  step {s:.0e} along -grad: loss {f:.8e}  "
            f"delta {f - val:+.3e}")
    pb.set_flat(theta0)
    total, train, test = pb.eval_all()
    out["train"], out["test"] = train, test
    say("train losses:", {k: f"{v:.3e}" for k, v in train.items()})
    say("test losses:", {k: f"{v:.3e}" for k, v in test.items()})
    return out


def _split64(t64: np.ndarray, dtype, device):
    hi = t64.astype(np.float32)
    lo = (t64 - hi.astype(np.float64)).astype(np.float32)
    return (torch.as_tensor(hi, dtype=dtype, device=device),
            torch.as_tensor(lo, dtype=dtype, device=device))


def mu_scan(pb, verbose: bool = True) -> dict:
    """The damping ladder scanned at ``pb``'s θ (see the module
    docstring); returns the eigenvalues and one row per μ."""
    theta0 = pb.get_flat()
    dtype, device = theta0.dtype, theta0.device
    n_par = int(theta0.shape[0])
    say = print if verbose else (lambda *a, **k: None)
    say("device:", device, "dtype:", dtype, "P:", n_par)

    def res_lin(hi, lo):
        r, dr = pb.residuals_jvp(hi, lo)
        return r.detach(), dr.detach()

    def pair_diff_split(r1, d1, r0, d0):
        return float(torch.dot((r1 - r0) + (d1 - d0),
                               (r1 + r0) + (d1 + d0)))

    theta64 = theta0.detach().cpu().numpy().astype(np.float64)
    r0, d0 = res_lin(*_split64(theta64, dtype, device))
    f0 = float(torch.dot(r0, r0))
    say("loss at theta0 (split eval):", f0)

    _, Jt = pb.residuals_jacobian(
        torch.as_tensor(theta64, dtype=dtype, device=device), JAC_CHUNK)
    JTJ = (Jt @ Jt.T).cpu().numpy().astype(np.float64)
    JTr = ((Jt @ r0).cpu().numpy().astype(np.float64)
           + (Jt @ d0).cpu().numpy().astype(np.float64))
    w, V = np.linalg.eigh(JTJ)
    w = np.maximum(w, 0.0)
    w_max = float(w[-1])
    c = V.T @ JTr
    say(f"|JTr|={np.linalg.norm(JTr):.3e}  w_max={w_max:.3e}  "
        f"w_min={float(w[0]):.3e}  "
        f"cond={w_max / max(float(w[0]), 1e-300):.1e}")

    hi0 = theta64.astype(np.float32)
    say(f"{'mu':>9} {'|delta|':>10} {'hi_chg':>7} {'df_split':>12} "
        f"{'df_pred':>12} {'ratio':>8}")
    rows = []
    for mu in MUS:
        lam = mu * w_max + np.finfo(np.float64).tiny
        s = -(c / (w + lam))
        delta = V @ s
        df_pred = float(2.0 * c @ s + s @ (w * s))
        t1 = theta64 + delta
        n_chg = int(np.sum(t1.astype(np.float32) != hi0))
        r1, d1 = res_lin(*_split64(t1, dtype, device))
        df = pair_diff_split(r1, d1, r0, d0)
        ratio = df / df_pred if df_pred != 0 else float("nan")
        rows.append({"mu": mu, "delta": float(np.linalg.norm(delta)),
                     "hi_chg": n_chg, "df_split": df, "df_pred": df_pred,
                     "ratio": ratio})
        say(f"{mu:9.0e} {np.linalg.norm(delta):10.3e} {n_chg:7d} "
            f"{df:12.4e} {df_pred:12.4e} {ratio:8.3f}")
    pb.set_flat(theta0)
    return {"dtype": str(dtype), "P": n_par, "loss_split": f0,
            "eigenvalues": w, "JTr": JTr, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("floor", "mu-scan"))
    ap.add_argument("--folder", required=True,
                    help="a saved coronary run folder")
    ap.add_argument("--base-dir", default=None,
                    help="the case's data and mesh (default: the folder's "
                         "parent)")
    ap.add_argument("--refine", type=int, default=0)
    ap.add_argument("--noise-bnd", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    pb = resumed_problem(args.folder, args.base_dir, args.refine,
                         args.noise_bnd, device=args.device)
    (floor if args.what == "floor" else mu_scan)(pb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
