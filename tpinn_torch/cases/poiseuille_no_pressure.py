"""Poiseuille flow without a pressure output: a 2-output net (u, v) with
the pressure gradient prescribed as a forcing, written in the tape style
of the reference's scripts.

    ρ (u·∇)u − μ Δu + ∂p/∂x = 0,  ∂p/∂x = (p_out − p_in)/L,  ∇·u = 0

on the 1 × 0.1 channel, with no-slip walls and the parabolic inflow
profile; the momentum residuals are divided by |∂p/∂x|.  A 2-32-32-32-2
tanh MLP, 800 PDE points, 50 points per wall and on the inflow, 1000 test
points; Adam at lr 1e-2 for 100 epochs, then the on-device L-BFGS (or,
with ``--second-round scipy``, the host scipy BFGS) for ``epochs``
iterations.  Run with::

    python -m tpinn_torch.cases.poiseuille_no_pressure --out-dir OUT \
        [--epochs 3000] [--second-round jax|scipy] [--device cpu]

It writes ``OUT/Images/Poiseuille_no_pressure_history.json``.
"""

from __future__ import annotations

import argparse
import os

import torch

import tpinn_torch as ns
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.cases.poisson import as_points
from tpinn_torch.experimental.physics import tens_style as operator
from tpinn_torch.geometry import sample_box
from tpinn_torch.oracles import analytic

PRM = analytic.PoiseuilleParams()
DIM = 2
EXTENTS = [(0.0, 1.0), (0.0, 0.1)]
NUM_PDE, NUM_BC, NUM_TEST = 800, 50, 1000
POINTS = ("x_PDE", "walls", "inflow", "x_test")


def make_model(device, generator=None, seed: int = 2, params=None):
    model = ns.models.MLP(2, 2, width=32, depth=3, seed=seed,
                          generator=generator, device=device,
                          input_extents=EXTENTS)
    if params is not None:
        model.set_params(params_from_numpy(params, dtype=model.dtype))
    return model


def build(model, pts: dict):
    """The optimization problem on the point sets ``pts`` (the names of
    ``POINTS``)."""
    x_PDE, walls, inflow, x_test = (pts[k] for k in POINTS)
    norm_vel = float(torch.max(analytic.poiseuille_u(x_test, PRM)))
    u_in = analytic.poiseuille_u(inflow, PRM) / norm_vel
    u_test = analytic.poiseuille_u(x_test, PRM) / norm_vel
    v_test = analytic.poiseuille_v(x_test, PRM) / norm_vel
    dpdx = PRM.p_x / PRM.L  # the prescribed pressure gradient

    def PDE_MOM(k):
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x_PDE)
            u_vect = model(x_PDE)
            u_eq = u_vect[:, k] * norm_vel
            grad_eq = operator.gradient_scalar(tape, u_eq, x_PDE)
            lapl_eq = operator.laplacian_scalar(tape, u_eq, x_PDE, DIM)
            conv = norm_vel * (u_vect[:, 0] * grad_eq[:, 0]
                               + u_vect[:, 1] * grad_eq[:, 1])
            forcing = dpdx if k == 0 else 0.0
            r = PRM.rho * conv - PRM.mu * lapl_eq + forcing
        return r / abs(dpdx)

    def PDE_MASS():
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x_PDE)
            uv = model(x_PDE)[:, 0:2]
            div = operator.divergence_vector(tape, uv, x_PDE, DIM)
        return div

    zeros = lambda x: torch.zeros_like(x[:, 0])
    LMS = ns.LossMeanSquares
    losses = [
        LMS("PDE_MASS", PDE_MASS, weight=1e1),
        LMS("PDE_MOMU", lambda: PDE_MOM(0)),
        LMS("PDE_MOMV", lambda: PDE_MOM(1)),
        LMS("BCD_walls_u", lambda: model(walls)[:, 0] - zeros(walls)),
        LMS("BCD_walls_v", lambda: model(walls)[:, 1] - zeros(walls)),
        LMS("BCD_in_u", lambda: model(inflow)[:, 0] - u_in),
        LMS("BCD_in_v", lambda: model(inflow)[:, 1] - zeros(inflow)),
    ]
    loss_test = [
        LMS("u_test", lambda: model(x_test)[:, 0] - u_test),
        LMS("v_test", lambda: model(x_test)[:, 1] - v_test),
    ]
    return ns.OptimizationProblem(model.variables, losses, loss_test)


def from_arrays(arrays: dict, params, device=None):
    """(pb, model) from given point sets (numpy) and initial weights."""
    model = make_model(device, params=params)
    return build(model, {k: as_points(arrays[k], model)
                         for k in POINTS}), model


def sample_points(generator: torch.Generator, model) -> dict:
    """PDE points in the channel, 50 on each wall (bottom, then top), 50
    on the inflow edge x = 0, test points in the channel."""
    box = lambda n, lo, hi: sample_box(generator, n, lo, hi,
                                       dtype=model.dtype).to(model.device)
    (lx, ux), (ly, uy) = EXTENTS
    return {
        "x_PDE": box(NUM_PDE, [lx, ly], [ux, uy]),
        "walls": torch.cat([box(NUM_BC, [lx, ly], [ux, ly]),
                            box(NUM_BC, [lx, uy], [ux, uy])]),
        "inflow": box(NUM_BC, [lx, ly], [lx, uy]),
        "x_test": box(NUM_TEST, [lx, ly], [ux, uy]),
    }


def train(pb, epochs: int, second_round: str = "jax") -> None:
    """Adam at lr 1e-2 for 100 epochs, then the host scipy BFGS
    ("scipy") or the on-device L-BFGS (any other name) for ``epochs``
    iterations."""
    ns.minimize(pb, "keras", ns.optimizers.Adam(1e-2), num_epochs=100)
    if second_round == "scipy":
        ns.minimize(pb, "scipy", "BFGS", num_epochs=epochs)
    else:
        ns.minimize(pb, "jax", "L-BFGS", num_epochs=epochs)


def main(epochs: int = 3000, out_dir: str = None, second_round: str = "jax",
         device=None, seed: int = 2):
    """Train from ``seed`` and write the history under ``out_dir``;
    returns (pb, model)."""
    if out_dir is None:
        raise ValueError("out_dir is required")
    gen = torch.Generator().manual_seed(seed)
    model = make_model(device, generator=gen)
    pb = build(model, sample_points(gen, model))
    train(pb, epochs, second_round)
    os.makedirs(os.path.join(out_dir, "Images"), exist_ok=True)
    pb.save_history(os.path.join(out_dir, "Images",
                                 "Poiseuille_no_pressure_history.json"))
    print("final test losses:",
          {k: v["log"][-1] for k, v in pb.history.losses_test.items()})
    return pb, model


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--second-round", default="jax", choices=["scipy", "jax"])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args()
    main(args.epochs, out_dir=args.out_dir, second_round=args.second_round,
         device=args.device)
