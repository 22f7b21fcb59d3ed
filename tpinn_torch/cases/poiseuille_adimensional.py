"""Dimensionless Poiseuille flow, written in the tape style of the
reference's scripts.

    (u·∇)u − Δu/Re + ∇p = 0,  ∇·u = 0        in (0, 1) × (0, H)
    u = v = 0                                on y = {0, H}
    u_x/Re − p = p_end,  v_x = 0             on x = 1 (traction outflow)
    u = u_ex, v = 0                          on x = 0 (inflow)

    p_ex(x) = (p_end − p_str) x + p_str,  u_ex(y) = −Re p_x y (2δ − y)/2

with the reference's lava channel (ρ 3100, μ 890, U_b 1, L 1, H 0.1) made
dimensionless with ``**`` (the reference's ``^`` is an integer XOR).  The
network predicts p/ρ, and the residuals multiply its gradient back by ρ
(``P_SCALE``), which keeps the pressure head O(0.1).  A 2-20-20-20-3 tanh
MLP, 200 PDE points, 20 points per edge, 10 hint points with the exact
values, 1000 test points; Adam at lr 1e-2 for 100 epochs, then scipy's
L-BFGS-B ("scipy"), the on-device dense BFGS ("jax-bfgs" / "bfgs") or the
on-device L-BFGS (any other name) for ``epochs`` iterations.  Run with::

    python -m tpinn_torch.cases.poiseuille_adimensional --out-dir OUT \
        [--epochs 1000] [--second-round scipy|jax|jax-bfgs] [--noise F] \
        [--plots] [--device cpu]

It writes ``OUT/Images/Poiseuille_adim_history_loss.json`` and, with
``--plots`` (matplotlib), the history plot and the 3-D scatters of u, v
and p against the exact solution.
"""

from __future__ import annotations

import argparse
import os

import torch

import tpinn_torch as ns
from tpinn_torch import viz
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.cases.poisson import as_points
from tpinn_torch.experimental.physics import tens_style as operator
from tpinn_torch.geometry import sample_box

DIM = 2
RHO, MU, UB, L_DIM, H_DIM = 3100.0, 890.0, 1.0, 1.0, 0.1
P_STR, P_END = 1e6, 0.0
RE = RHO * UB * L_DIM / MU
L, H = 1.0, H_DIM / L_DIM
DELTA = H / 2
p_str = P_STR / (RHO * UB**2)
p_end = P_END / (RHO * UB**2)
P_X = p_end - p_str
P_SCALE = RHO
NUM_PDE, NUM_BC, NUM_HINT, NUM_TEST = 200, 20, 10, 1000
POINTS = ("x_PDE", "x_hint", "x_BC_x0", "x_BC_x1", "x_BC_y0", "x_BC_y1",
          "x_test")

u_exact = lambda x: -RE * P_X * x[:, 1] * (2 * DELTA - x[:, 1]) / 2
v_exact = lambda x: 0 * x[:, 0]
p_exact = lambda x: ((p_end - p_str) / L * x[:, 0] + p_str) / P_SCALE


def make_model(device, generator=None, seed: int = 1, params=None):
    model = ns.models.MLP(2, 3, width=20, depth=3, seed=seed,
                          generator=generator, device=device,
                          input_extents=[(0.0, L), (0.0, H)])
    if params is not None:
        model.set_params(params_from_numpy(params, dtype=model.dtype))
    return model


def create_rhs(x, force, noise_factor: float = 0.0, generator=None):
    """None → zeros, a float → that constant, a callable → force(x); plus
    noise_factor·N(0, 1) when a generator is given."""
    if force is None:
        rhs = torch.zeros_like(x[:, 0])
    elif isinstance(force, float):
        rhs = torch.full_like(x[:, 0], force)
    else:
        rhs = torch.as_tensor(force(x), dtype=x.dtype)
    if noise_factor and generator is not None:
        rhs = rhs + noise_factor * torch.randn(
            x.shape[0], generator=generator, dtype=x.dtype).to(x.device)
    return rhs


def build(model, pts: dict, noise: float = 0.0, generator=None):
    """The optimization problem on the point sets ``pts`` (the names of
    ``POINTS``); ``noise`` > 0 perturbs the inflow and hint data with
    draws from ``generator``, made once here."""
    x_PDE, x_hint, x_BC_x0, x_BC_x1, x_BC_y0, x_BC_y1, x_test = (
        pts[k] for k in POINTS)

    def data(x, sol, noisy=False):
        return create_rhs(x, sol, noise if noisy else 0.0, generator)

    rhs_x0_u = data(x_BC_x0, u_exact, noisy=True)
    rhs_hint = [data(x_hint, u_exact, noisy=True), data(x_hint, v_exact),
                data(x_hint, p_exact, noisy=True)]
    rhs_test = [data(x_test, s) for s in (u_exact, v_exact, p_exact)]

    def PDE_MASS():
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x_PDE)
            u_vect = model(x_PDE)[:, 0:2]
            div = operator.divergence_vector(tape, u_vect, x_PDE, DIM)
        return div

    def PDE_MOM(x, k, force):
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x)
            u_vect = model(x)
            u, v = u_vect[:, 0], u_vect[:, 1]
            u_eq = u_vect[:, k]
            grad_eq = operator.gradient_scalar(tape, u_eq, x)
            dp = operator.gradient_scalar(tape, u_vect[:, 2], x)[:, k] \
                * P_SCALE
            lapl_eq = operator.laplacian_scalar(tape, u_eq, x, DIM)
        rhs = create_rhs(x, force)
        return ((u * grad_eq[:, 0] + v * grad_eq[:, 1]) - lapl_eq / RE + dp
                - rhs)

    def BC_D(x, k, rhs=None):
        return model(x)[:, k] - (create_rhs(x, None) if rhs is None else rhs)

    def BC_N(x, k, j, pr=None):
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x)
            uk = model(x)[:, k]
            duk_j = operator.gradient_scalar(tape, uk, x)[:, j]
        p = model(x)[:, 2] * P_SCALE * (k == j)
        rhs = create_rhs(x, pr) * (k == j)
        return 1 / RE * duk_j - p - rhs

    def exact_value(x, k, rhs):
        return model(x)[:, k] - rhs

    LMS = ns.LossMeanSquares
    losses = [
        LMS("PDE_MASS", PDE_MASS, normalization=1e4, weight=1e0),
        LMS("PDE_MOMU", lambda: PDE_MOM(x_PDE, 0, None), normalization=1e4,
            weight=1e-2),
        LMS("PDE_MOMV", lambda: PDE_MOM(x_PDE, 1, None), normalization=1e4,
            weight=1e-2),
        LMS("BCD_x0_u", lambda: BC_D(x_BC_x0, 0, rhs_x0_u), weight=1e2),
        LMS("BCD_x0_v", lambda: BC_D(x_BC_x0, 1), weight=1e2),
        LMS("BCD_y0_u", lambda: BC_D(x_BC_y0, 0), weight=1e0),
        LMS("BCD_y0_v", lambda: BC_D(x_BC_y0, 1), weight=1e0),
        LMS("BCD_y1_u", lambda: BC_D(x_BC_y1, 0), weight=1e0),
        LMS("BCD_y1_v", lambda: BC_D(x_BC_y1, 1), weight=1e0),
        # the traction residual carries p·P_SCALE ~ O(300): normalized
        LMS("BCN_x1_u", lambda: BC_N(x_BC_x1, 0, 0, p_end), weight=1e2,
            normalization=P_SCALE),
        LMS("BCN_x1_v", lambda: BC_N(x_BC_x1, 1, 0), weight=1e2),
        LMS("exact_u", lambda: exact_value(x_hint, 0, rhs_hint[0])),
        LMS("exact_v", lambda: exact_value(x_hint, 1, rhs_hint[1])),
        LMS("exact_p", lambda: exact_value(x_hint, 2, rhs_hint[2])),
    ]
    loss_test = [
        LMS(name, lambda k=k: exact_value(x_test, k, rhs_test[k]))
        for k, name in enumerate(("u_fit", "v_fit", "p_fit"))
    ]
    return ns.OptimizationProblem(model.variables, losses, loss_test)


def from_arrays(arrays: dict, params, device=None):
    """(pb, model) from given point sets (numpy) and initial weights."""
    model = make_model(device, params=params)
    return build(model, {k: as_points(arrays[k], model)
                         for k in POINTS}), model


def sample_points(generator: torch.Generator, model) -> dict:
    """PDE, hint and test points in the channel and 20 points on each edge
    (x = 0, x = L, y = 0, y = H)."""
    box = lambda n, lo, hi: sample_box(generator, n, lo, hi,
                                       dtype=model.dtype).to(model.device)
    return {
        "x_PDE": box(NUM_PDE, [0, 0], [L, H]),
        "x_hint": box(NUM_HINT, [0, 0], [L, H]),
        "x_BC_x0": box(NUM_BC, [0, 0], [0, H]),
        "x_BC_x1": box(NUM_BC, [L, 0], [L, H]),
        "x_BC_y0": box(NUM_BC, [0, 0], [L, 0]),
        "x_BC_y1": box(NUM_BC, [0, H], [L, H]),
        "x_test": box(NUM_TEST, [0, 0], [L, H]),
    }


def train(pb, epochs: int, second_round: str = "scipy") -> None:
    """Adam at lr 1e-2 for 100 epochs, then ``epochs`` iterations of
    scipy's L-BFGS-B ("scipy"), the on-device dense BFGS ("jax-bfgs",
    "bfgs") or the on-device L-BFGS (any other name)."""
    ns.minimize(pb, "keras", ns.optimizers.Adam(learning_rate=1e-2),
                num_epochs=100)
    if second_round == "scipy":
        ns.minimize(pb, "scipy", "L-BFGS-B", num_epochs=epochs)
    elif second_round in ("jax-bfgs", "bfgs"):
        ns.minimize(pb, "jax", "BFGS", num_epochs=epochs)
    else:
        ns.minimize(pb, "jax", "L-BFGS", num_epochs=epochs)


def main(epochs: int = 1000, out_dir: str = None, second_round: str = "scipy",
         noise: float = 0.0, device=None, seed: int = 1,
         save_plots: bool = False):
    """Train from ``seed`` and write the history (and, with
    ``save_plots``, the figures) under ``out_dir``; returns (pb, model)."""
    if out_dir is None:
        raise ValueError("out_dir is required")
    gen = torch.Generator().manual_seed(seed)
    model = make_model(device, generator=gen)
    pts = sample_points(gen, model)
    pb = build(model, pts, noise=noise, generator=gen)
    train(pb, epochs, second_round)

    images = os.path.join(out_dir, "Images")
    os.makedirs(images, exist_ok=True)
    history_file = os.path.join(images, "Poiseuille_adim_history_loss.json")
    pb.save_history(history_file)
    if save_plots:
        ns.utils.plot_history(history_file)
        x_test = pts["x_test"]
        with torch.no_grad():
            out = model(x_test)
        for k, (name, sol) in enumerate(
                [("u", u_exact), ("v", v_exact), ("p", p_exact)]):
            viz.scatter3d_compare(
                x_test[:, 0], x_test[:, 1], sol(x_test), out[:, k],
                filename=os.path.join(images, f"Poiseuille_adim_{name}.png"))
    h = pb.history
    print(f"Reynolds Number -> {RE}")
    print("final global loss: %.3e" % h.loss_global[-1])
    print("final test losses:", {k: "%.3e" % h.losses_test[k]["log"][-1]
                                 for k in ("u_fit", "v_fit", "p_fit")})
    return pb, model


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--second-round", default="scipy",
                    choices=["scipy", "jax", "jax-bfgs", "bfgs"])
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--plots", action="store_true",
                    help="plot the history and the scatters (matplotlib)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args()
    main(args.epochs, out_dir=args.out_dir, second_round=args.second_round,
         noise=args.noise, device=args.device, save_plots=args.plots)
