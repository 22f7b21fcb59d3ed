"""Colliding flow with a mean-pressure gauge penalty instead of a pressure
fitting point, written in the tape style of the reference's scripts.

The generic ``ns.Loss`` with ``non_negative=True`` carries the gauge,
|mean p| over 50 points (``PRESS_0``), and the PDE losses divide their
residuals by ``normalization`` 1e4.  A 2-32-32-32-3 tanh MLP, 1000 PDE
points, 100 boundary points per edge, 5 collocation points for u and v,
2000 test points; Adam at lr 1e-2 for 100 epochs, then the second round of
the drivers' routing table (``run_second_round``) for ``epochs``
iterations.  Run with::

    python -m tpinn_torch.cases.colliding_flow_pressmean --out-dir OUT \
        [--epochs 5000] [--second-round scipy|jax|...] [--noise] \
        [--device cpu]

It writes ``OUT/Images/Colliding_pressmean_history.json``.
"""

from __future__ import annotations

import argparse
import os

import torch

import tpinn_torch as ns
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.cases.poisson import as_points
from tpinn_torch.driver import SECOND_ROUND_CHOICES, run_second_round
from tpinn_torch.experimental.physics import tens_style as operator
from tpinn_torch.geometry import generate_noise, sample_box
from tpinn_torch.oracles import analytic

DIM = 2
NUM_PDE, NUM_BCD, NUM_COL, NUM_PRES, NUM_TEST = 1000, 400, 5, 50, 2000
VEL_MAX, P_MAX = 20.0, 80.0
EXTENTS = [(-1.0, 1.0), (-1.0, 1.0)]
POINTS = ("x_PDE", "x_BCD", "x_col", "x_pres", "x_test", "noise_x",
          "noise_y")


def make_model(device, generator=None, seed: int = 1, params=None):
    model = ns.models.MLP(2, 3, width=32, depth=3, seed=seed,
                          generator=generator, device=device,
                          input_extents=EXTENTS)
    if params is not None:
        model.set_params(params_from_numpy(params, dtype=model.dtype))
    return model


def build(model, pts: dict):
    """The optimization problem on the point sets ``pts`` (the names of
    ``POINTS``)."""
    x_PDE, x_BCD, x_col, x_pres, x_test, noise_x, noise_y = (
        pts[k] for k in POINTS)
    u_exact, v_exact, p_exact = (analytic.colliding_u, analytic.colliding_v,
                                 analytic.colliding_p)

    def PDE_MASS():
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x_PDE)
            u_vect = model(x_PDE)[:, 0:2] * VEL_MAX
            div = operator.divergence_vector(tape, u_vect, x_PDE, DIM)
        return div

    def PDE_MOM(k):
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x_PDE)
            u_vect = model(x_PDE)
            p = u_vect[:, 2] * P_MAX
            u_eq = u_vect[:, k] * VEL_MAX
            dp = operator.gradient_scalar(tape, p, x_PDE)[:, k]
            lapl_eq = operator.laplacian_scalar(tape, u_eq, x_PDE, DIM)
        return -(lapl_eq) + dp

    def BC_D(k, sol, norm, noise):
        return model(x_BCD)[:, k] - (sol(x_BCD) + noise) / norm

    def COL(x, k, sol, norm):
        return model(x)[:, k] - sol(x) / norm

    def PRESS_0():
        return torch.abs(torch.mean(model(x_pres)[:, 2]))

    LMS = ns.LossMeanSquares
    losses = [
        LMS("PDE_MASS", PDE_MASS, normalization=1e4, weight=1e0),
        LMS("PDE_MOMU", lambda: PDE_MOM(0), normalization=1e4, weight=1e-2),
        LMS("PDE_MOMV", lambda: PDE_MOM(1), normalization=1e4, weight=1e-2),
        LMS("BCD_u", lambda: BC_D(0, u_exact, VEL_MAX, noise_x), weight=1e0),
        LMS("BCD_v", lambda: BC_D(1, v_exact, VEL_MAX, noise_y), weight=1e0),
        LMS("COL_u", lambda: COL(x_col, 0, u_exact, VEL_MAX), weight=1e0),
        LMS("COL_v", lambda: COL(x_col, 1, v_exact, VEL_MAX), weight=1e0),
        ns.Loss("PRESS_0", PRESS_0, normalization=1e0, weight=1e-2,
                non_negative=True),
    ]
    loss_test = [
        LMS("u_test", lambda: COL(x_test, 0, u_exact, VEL_MAX)),
        LMS("v_test", lambda: COL(x_test, 1, v_exact, VEL_MAX)),
        LMS("p_test", lambda: COL(x_test, 2, p_exact, P_MAX)),
    ]
    return ns.OptimizationProblem(model.variables, losses, loss_test)


def from_arrays(arrays: dict, params, device=None):
    """(pb, model) from given point sets (numpy, the names of ``POINTS``)
    and initial weights, e.g. the JAX package's draws."""
    model = make_model(device, params=params)
    return build(model, {k: as_points(arrays[k], model)
                         for k in POINTS}), model


def sample_points(generator: torch.Generator, model,
                  use_noise: bool = False) -> dict:
    """The script's point sets: PDE points in the square, 100 on each edge
    (x = −1, x = 1, y = −1, y = 1), the collocation, gauge and test points,
    and the boundary noise (0.1·N(0, 1) with ``use_noise``, else zeros)."""
    box = lambda n, lo, hi: sample_box(generator, n, lo, hi,
                                       dtype=model.dtype).to(model.device)
    q = NUM_BCD // 4
    pts = {
        "x_PDE": box(NUM_PDE, [-1, -1], [1, 1]),
        "x_BCD": torch.cat([box(q, [-1, -1], [-1, 1]), box(q, [1, -1], [1, 1]),
                            box(q, [-1, -1], [1, -1]), box(q, [-1, 1], [1, 1])]),
        "x_col": box(NUM_COL, [-1, -1], [1, 1]),
        "x_pres": box(NUM_PRES, [-1, -1], [1, 1]),
    }
    for k in ("noise_x", "noise_y"):
        pts[k] = generate_noise(generator, NUM_BCD, 1e-1 if use_noise
                                else 0.0, dtype=model.dtype).to(model.device)
    pts["x_test"] = box(NUM_TEST, [-1, -1], [1, 1])
    return pts


def train(pb, epochs: int, second_round: str = "scipy") -> None:
    """Adam at lr 1e-2 for 100 epochs, then ``second_round`` through the
    drivers' routing table for ``epochs`` iterations."""
    ns.minimize(pb, "keras", ns.optimizers.Adam(learning_rate=1e-2),
                num_epochs=100)
    run_second_round(pb, second_round, epochs)


def main(epochs: int = 5000, out_dir: str = None, second_round: str = "scipy",
         use_noise: bool = False, device=None, seed: int = 1):
    """Train from ``seed`` (weights, then points, from one generator) and
    write the history under ``out_dir``; returns (pb, model)."""
    if out_dir is None:
        raise ValueError("out_dir is required")
    gen = torch.Generator().manual_seed(seed)
    model = make_model(device, generator=gen)
    pb = build(model, sample_points(gen, model, use_noise))
    train(pb, epochs, second_round)
    os.makedirs(os.path.join(out_dir, "Images"), exist_ok=True)
    pb.save_history(os.path.join(out_dir, "Images",
                                 "Colliding_pressmean_history.json"))
    print("final test losses:",
          {k: v["log"][-1] for k, v in pb.history.losses_test.items()})
    return pb, model


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--epochs", type=int, default=5000)
    ap.add_argument("--second-round", default="scipy",
                    choices=SECOND_ROUND_CHOICES)
    ap.add_argument("--noise", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args()
    main(args.epochs, out_dir=args.out_dir, second_round=args.second_round,
         use_noise=args.noise, device=args.device)
