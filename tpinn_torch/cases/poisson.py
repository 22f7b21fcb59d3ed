"""Poisson problem with Dirichlet BCs, as examples/Poisson_Problem/poisson.py.

    -Δu = 2 sin(x) sin(y)   in Ω = (0, 2π)²
       u = 0                on ∂Ω
    u_exact = sin(x) sin(y)

A 2→20→20→20→1 tanh MLP (layer 0 folds the input extents), 200 PDE points,
20 boundary points per edge, 1000 test points; Adam at lr 1e-2 for 100
epochs, then scipy's L-BFGS-B (or, with ``--second-round jax-bfgs``, the
on-device dense BFGS) for ``epochs`` iterations, in float64.  The PDE loss
goes through the fused one-pass Poisson objective when the CUDA kernels
take the net (on the card: one launch of the backward kernel per Adam step,
scipy evaluation or BFGS trial, the forward kernel at log points), else
through the tape.  Run with::

    python -m tpinn_torch.cases.poisson --out-dir OUT [--epochs 500] \
        [--second-round scipy|jax-bfgs] [--device cpu]

It writes ``OUT/Images/Poisson_history_loss.json``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import tpinn_torch as ns
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.experimental.physics import tens_style as operator
from tpinn_torch.geometry import sample_box
from tpinn_torch.losses import PrecomputedMeanSquares
from tpinn_torch.oracles import analytic
from tpinn_torch.pipeline import FusedPoissonObjective, use_fused_pde_losses

DIM = 2
W = 2 * np.pi
NUM_PDE, NUM_BC, NUM_TEST = 200, 20, 1000
ADAM_EPOCHS = 100


def make_model(device, generator=None, seed: int = 1, params=None):
    """The examples' network; ``params`` (numpy, the JAX package's layout)
    replace the initial weights."""
    model = ns.models.MLP(2, 1, width=20, depth=3, seed=seed,
                          generator=generator, device=device,
                          input_extents=[(0.0, W), (0.0, W)])
    if params is not None:
        model.set_params(params_from_numpy(params, dtype=model.dtype))
    return model


def as_points(a, model) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=model.dtype,
                           device=model.device)


def pde_loss(model, x_PDE, f, weight: float):
    """The PDE loss as the examples route it: the fused one-pass objective
    for a net the kernels take, else −Δu − f through the tape."""
    if use_fused_pde_losses(model, False, DIM):
        fused = FusedPoissonObjective(model, x_PDE, f, weight=weight)
        return PrecomputedMeanSquares("PDE", fused.loss_fn(), weight=weight)

    def PDE():
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x_PDE)
            u = model(x_PDE)
            laplacian = operator.laplacian_scalar(tape, u, x_PDE, DIM)
        return -laplacian - f

    return ns.LossMeanSquares("PDE", PDE, weight=weight)


def train(pb, epochs: int, second_round: str = "scipy") -> None:
    """Adam at lr 1e-2 for 100 epochs, then ``epochs`` iterations of the
    second round: "scipy" the host L-BFGS-B, "jax-bfgs" / "bfgs" the
    on-device dense BFGS.  The LM round ("lm", "jax-lm", "gn") and the
    on-device L-BFGS (any other name) are not ported for these cases and
    raise before training."""
    if second_round in ("lm", "jax-lm", "gn"):
        raise NotImplementedError(
            f"second round {second_round!r}: the LM round of the Poisson "
            "cases (their per-point residuals) is not ported yet "
            "(ROADMAP.md, port queue 1, item 8)")
    if second_round not in ("scipy", "jax-bfgs", "bfgs"):
        raise NotImplementedError(
            f"second round {second_round!r}: the on-device L-BFGS round is "
            "not ported yet (ROADMAP.md, port queue 1, item 4)")
    ns.minimize(pb, "keras", ns.optimizers.Adam(learning_rate=1e-2),
                num_epochs=ADAM_EPOCHS)
    if second_round == "scipy":
        ns.minimize(pb, "scipy", "L-BFGS-B", num_epochs=epochs)
    else:
        ns.minimize(pb, "jax", "BFGS", num_epochs=epochs)


def build(model, x_PDE, x_BC, x_test):
    """The optimization problem on the given points."""
    u_test = analytic.poisson_exact(x_test)[:, None]
    f = analytic.poisson_forcing(x_PDE)
    losses = [
        pde_loss(model, x_PDE, f, weight=2.0),
        ns.LossMeanSquares("BC", lambda: model(x_BC)),
    ]
    loss_test = ns.LossMeanSquares("fit", lambda: model(x_test) - u_test)
    return ns.OptimizationProblem(model.variables, losses, loss_test)


def from_arrays(x_PDE, x_BC, x_test, params, device=None):
    """(pb, model) from given points and initial weights (numpy), e.g. the
    JAX package's draws."""
    model = make_model(device, params=params)
    pts = [as_points(a, model) for a in (x_PDE, x_BC, x_test)]
    return build(model, *pts), model


def sample_points(generator: torch.Generator, model):
    """The examples' point sets: PDE points in Ω, 20 points on each edge
    (x = 0, x = 2π, y = 0, y = 2π), test points in Ω."""
    box = lambda n, lo, hi: sample_box(generator, n, lo, hi,
                                       dtype=model.dtype).to(model.device)
    x_PDE = box(NUM_PDE, [0, 0], [W, W])
    x_BC = torch.cat([box(NUM_BC, [0, 0], [0, W]), box(NUM_BC, [W, 0], [W, W]),
                      box(NUM_BC, [0, 0], [W, 0]), box(NUM_BC, [0, W], [W, W])])
    x_test = box(NUM_TEST, [0, 0], [W, W])
    return x_PDE, x_BC, x_test


def main(epochs: int = 500, out_dir: str = None, second_round: str = "scipy",
         device=None, seed: int = 1, save_plots: bool = False):
    """Train from ``seed`` (weights, then points, from one generator) and
    write the history under ``out_dir``; returns (pb, model)."""
    if out_dir is None:
        raise ValueError("out_dir is required")
    gen = torch.Generator().manual_seed(seed)
    model = make_model(device, generator=gen)
    pb = build(model, *sample_points(gen, model))
    train(pb, epochs, second_round)

    os.makedirs(os.path.join(out_dir, "Images"), exist_ok=True)
    history_file = os.path.join(out_dir, "Images", "Poisson_history_loss.json")
    pb.save_history(history_file)
    if save_plots:
        ns.utils.plot_history(history_file)
    print(f"final global loss: {pb.history.loss_global[-1]:.3e}")
    print(f"final test MSE:    {pb.history.losses_test['fit']['log'][-1]:.3e}")
    return pb, model


def cli(main_fn, default_epochs: int):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--epochs", type=int, default=default_epochs,
                    help="second-round iterations after the 100 Adam epochs")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    ap.add_argument("--second-round", default="scipy",
                    choices=["scipy", "jax-bfgs", "bfgs"],
                    help="the host L-BFGS-B or the on-device dense BFGS")
    ap.add_argument("--plots", action="store_true",
                    help="also plot the history (needs matplotlib)")
    args = ap.parse_args()
    main_fn(args.epochs, out_dir=args.out_dir, device=args.device,
            second_round=args.second_round, save_plots=args.plots)


if __name__ == "__main__":
    cli(main, 500)
