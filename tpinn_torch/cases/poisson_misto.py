"""Poisson problem with mixed Dirichlet/Neumann BCs, as
examples/Poisson_Problem/poisson_misto.py.

    -Δu = 2 sin(x) sin(y)   in Ω = (0, 2π)²
       u = 0                on the y-edges (Dirichlet)
     u_x = sin(y)           on the x-edges (Neumann, through the tape)

The network, points and rounds of :mod:`tpinn_torch.cases.poisson`, with
the PDE weight 1e2 and 7500 second-round iterations by default.  Run
with::

    python -m tpinn_torch.cases.poisson_misto --out-dir OUT \
        [--second-round scipy|jax-bfgs|jax|lm] [--device cpu]

It writes ``OUT/Images/Poisson_misto_history_loss.json``.
"""

from __future__ import annotations

import os

import torch

import tpinn_torch as ns
from tpinn_torch.cases.poisson import (
    NUM_BC,
    NUM_PDE,
    NUM_TEST,
    W,
    as_points,
    cli,
    make_model,
    pde_loss,
    train,
    value_point_residual,
)
from tpinn_torch.experimental.physics import tens_style as operator
from tpinn_torch.geometry import sample_box
from tpinn_torch.oracles import analytic
from tpinn_torch.pipeline import taylor_tri_fn


def build(model, x_PDE, x_BC_D, x_BC_N, x_test, second_round: str = "scipy"):
    """The optimization problem on the given points, its PDE loss routed
    for ``second_round``."""
    u_test = analytic.poisson_exact(x_test)[:, None]
    f = analytic.poisson_forcing(x_PDE)
    g_N = analytic.poisson_neumann_x(x_BC_N)

    def BC_N():
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x_BC_N)
            u = model(x_BC_N)
            du = operator.gradient_scalar(tape, u, x_BC_N)
        return du[:, 0] - g_N

    tri = taylor_tri_fn(model, 2)

    def bcn_pt(params, xi, g_i):
        _, jac, _ = tri(params, xi[None, :])
        return jac[0, 0, 0] - g_i

    losses = [
        pde_loss(model, x_PDE, f, weight=1e2, second_round=second_round),
        ns.LossMeanSquares("BC_D", lambda: model(x_BC_D),
                           point_residual=(value_point_residual(model),
                                           (x_BC_D,))),
        ns.LossMeanSquares("BC_N", BC_N,
                           point_residual=(bcn_pt, (x_BC_N, g_N))),
    ]
    loss_test = ns.LossMeanSquares("fit", lambda: model(x_test) - u_test)
    return ns.OptimizationProblem(model.variables, losses, loss_test)


def from_arrays(x_PDE, x_BC_D, x_BC_N, x_test, params, device=None,
                second_round: str = "scipy"):
    """(pb, model) from given points and initial weights (numpy)."""
    model = make_model(device, params=params)
    pts = [as_points(a, model) for a in (x_PDE, x_BC_D, x_BC_N, x_test)]
    return build(model, *pts, second_round=second_round), model


def sample_points(generator: torch.Generator, model):
    box = lambda n, lo, hi: sample_box(generator, n, lo, hi,
                                       dtype=model.dtype).to(model.device)
    x_PDE = box(NUM_PDE, [0, 0], [W, W])
    x_BC_D = torch.cat([box(NUM_BC, [0, 0], [W, 0]),    # y = 0
                        box(NUM_BC, [0, W], [W, W])])   # y = 2π
    x_BC_N = torch.cat([box(NUM_BC, [0, 0], [0, W]),    # x = 0
                        box(NUM_BC, [W, 0], [W, W])])   # x = 2π
    x_test = box(NUM_TEST, [0, 0], [W, W])
    return x_PDE, x_BC_D, x_BC_N, x_test


def main(epochs: int = 7500, out_dir: str = None,
         second_round: str = "scipy", device=None, seed: int = 1,
         save_plots: bool = False):
    """Train from ``seed`` and write the history under ``out_dir``; returns
    (pb, model)."""
    if out_dir is None:
        raise ValueError("out_dir is required")
    gen = torch.Generator().manual_seed(seed)
    model = make_model(device, generator=gen)
    pts = sample_points(gen, model)
    pb = build(model, *pts, second_round=second_round)
    train(pb, epochs, second_round)

    os.makedirs(os.path.join(out_dir, "Images"), exist_ok=True)
    history_file = os.path.join(out_dir, "Images",
                                "Poisson_misto_history_loss.json")
    pb.save_history(history_file)
    if save_plots:
        ns.utils.plot_history(history_file)
    x_test = pts[-1]
    with torch.no_grad():
        sup_err = float(torch.max(torch.abs(
            model(x_test)[:, 0] - analytic.poisson_exact(x_test))))
    print(f"final global loss: {pb.history.loss_global[-1]:.3e}")
    print(f"final test MSE:    {pb.history.losses_test['fit']['log'][-1]:.3e}")
    print(f"||u - u_ex||_inf:  {sup_err:.4f}")
    return pb, model


if __name__ == "__main__":
    cli(main, 7500)
