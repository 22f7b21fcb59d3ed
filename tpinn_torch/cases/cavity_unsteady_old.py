"""The unsteady lid-driven cavity in the old script style, on (t, x, y),
written in the tape style of the reference's scripts.

U = 1, ν = 1, T = 1e-2, dt = 1e-4: the 100 × 101 × 101 space-time grid with
the cavity oracle's per-step series as exact data (made by
:func:`tpinn_torch.oracles.generate.generate_cavity_unsteady` into
``OUT/data/UnsteadyCase`` when missing, each step's pressure recentred).

* The PDE, collocation, pressure and test sets are ``random.sample``
  subsets of the whole grid, drawn in that order from Python's ``random``
  seeded 1 (the collocation subset also carries the pressure fit, as in
  the reference);
* boundary points uniform in (t, edge) and initial points at t = 0;
* per-group enable flags (``use_pdelosses``, ``use_boundaryc``,
  ``use_initialco``, ``coll_velocity``, ``coll_pressure``);
* an initial-condition pressure loss ``CI_p`` beside ``CI_u``, ``CI_v``;
* ``PDE_MASS`` at normalization 1e0, the momentum at 1e4, all at weight
  1e-2; 0.1·N(0, 1) noise on each edge's u and v values (``use_noise``).

Adam at lr 1e-2 for 100 epochs, then ``epochs`` iterations of the host
scipy BFGS ("scipy"), the on-device dense BFGS ("jax-bfgs") or the
on-device L-BFGS ("jax").  Run with::

    python -m tpinn_torch.cases.cavity_unsteady_old --out-dir OUT \
        [--epochs 5000] [--second-round scipy|jax|jax-bfgs|none] \
        [--no-noise] [--no-plots] [--device cpu]

It writes ``OUT/Images/`` (the history JSON, and where matplotlib is
installed the loss trend and the exact-vs-PINN contours at five time
stamps from the regular-grid ``..._r.csv``).
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

import tpinn_torch as ns
from tpinn_torch import config, utils
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.cases.cavity_steady_csv import train
from tpinn_torch.cases.poisson import as_points
from tpinn_torch.experimental.physics import tens_style as operator
from tpinn_torch.geometry import generate_noise, sample_box
from tpinn_torch.models import Model
from tpinn_torch.oracles import generate, io

problem_name = "Lid Driven Cavity - Unsteady"

DIM = 3
A, B = 0.0, 1.0
U = 1.0
T = 1e-2
DT = 1e-4
SEED = 1  # the weights, points, noise and subsets, as in the reference
NUM_TIMES = int(T / DT)
EDGES = ("x0", "x1", "y0", "y1")
# the boundary and initial points and each edge's (u, v) noise (None: no
# noise)
POINTS = (tuple(f"x_BC_{e}" for e in EDGES) + ("x_CI",)
          + tuple(f"noise_{e}_{c}" for e in EDGES for c in "uv"))
SUBSETS = ("PDE", "col", "pres", "test")
DEFAULT_SIZES = dict(num_PDE=10000, num_BC=5000, num_CI=9000, num_col=1000,
                     num_pres=2500, num_test=7500)


def space_time_grid() -> np.ndarray:
    """The (t, x, y) rows of the grid, x fastest, then y, then t."""
    time_vector = np.arange(0.0, T, step=DT)
    xs = np.linspace(A, B, 101)
    tt, jj, ii = np.meshgrid(time_vector, xs, xs, indexing="ij")
    return np.stack([tt.ravel(), ii.ravel(), jj.ravel()], axis=1)


def sample_subsets(n: int, sizes: dict) -> dict:
    """The PDE, collocation, pressure and test index subsets of an n-row
    grid, ``random.sample`` draws in that order from Python's ``random``
    seeded ``SEED``."""
    rng = random.Random(SEED)
    sequence = list(range(n))
    return {k: np.asarray(rng.sample(sequence, sizes[f"num_{k}"]))
            for k in SUBSETS}


def load_series(out_dir: str, device=None):
    """(folder, (u, v, p)): the oracle's series in OUT/data/UnsteadyCase,
    made first where missing, concatenated step after step."""
    folder = generate.generate_cavity_unsteady(
        os.path.join(out_dir, "data"), U=U, T=T, dt=DT, device=device)
    return folder, io.read_unsteady_series(folder, NUM_TIMES)


def make_model(device, generator=None, params=None) -> Model:
    model = Model([3, 32, 32, 32, 3], activation="tanh", seed=SEED,
                  generator=generator, device=device,
                  input_extents=[(0.0, T), (A, B), (A, B)])
    if params is not None:
        model.set_params(params_from_numpy(params, dtype=model.dtype))
    return model


def scales(series):
    """(vel_max, p_max): the largest velocity spread and the pressure
    spread over the whole series."""
    u, v, p = series
    return (float(max(np.max(u) - np.min(u), np.max(v) - np.min(v))),
            float(np.max(p) - np.min(p)))


def build(model, var: np.ndarray, series, subsets: dict, pts: dict,
          use_pdelosses: bool = True, use_boundaryc: bool = True,
          use_initialco: bool = True, coll_velocity: bool = True,
          coll_pressure: bool = True):
    """The optimization problem on the grid ``var``, the exact ``series``,
    the index ``subsets`` and the boundary / initial points and noise
    ``pts`` (the names of ``POINTS``)."""
    dtype = model.dtype
    vel_max, p_max = scales(series)
    u_num, v_num, p_num = (as_points(a, model) for a in series)
    # the pressure subset is drawn (the later draws depend on it) but not
    # used: the pressure fit takes the collocation subset, as the
    # reference's script does
    used = {k: idx for k, idx in subsets.items() if k != "pres"}
    at = {k: as_points(var[idx], model) for k, idx in used.items()}
    ix = {k: torch.as_tensor(idx, device=model.device)
          for k, idx in used.items()}
    x_PDE = at["PDE"]
    x_BC = {e: pts[f"x_BC_{e}"] for e in EDGES}
    noise = {e: (pts[f"noise_{e}_u"], pts[f"noise_{e}_v"]) for e in EDGES}
    x_CI = pts["x_CI"]

    def create_rhs(x, force, noise=None):
        rhs = torch.zeros(x.shape[0], dtype=dtype, device=x.device)
        if isinstance(force, (int, float)) and force:
            rhs = rhs + force
        if noise is not None:
            rhs = rhs + noise
        return rhs

    def PDE_MASS(x):
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x)
            u_vect = model(x)[:, 0:2] * vel_max
            du_x = operator.gradient_scalar(tape, u_vect[:, 0], x)[:, 1]
            dv_y = operator.gradient_scalar(tape, u_vect[:, 1], x)[:, 2]
        return du_x + dv_y

    def PDE_MOM(x, k, force):
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x)
            u_vect = model(x)
            p = u_vect[:, 2] * p_max
            u_eq = u_vect[:, k] * vel_max
            dp = operator.gradient_scalar(tape, p, x)[:, k + 1]
            du = operator.gradient_scalar(tape, u_eq, x)
            du_t, du_x, du_y = du[:, 0], du[:, 1], du[:, 2]
            du_xx = operator.gradient_scalar(tape, du_x, x)[:, 1]
            du_yy = operator.gradient_scalar(tape, du_y, x)[:, 2]
            conv1 = vel_max * u_vect[:, 0] * du_x
            conv2 = vel_max * u_vect[:, 1] * du_y
        rhs = create_rhs(x, force)
        return du_t - du_xx - du_yy + dp + conv1 + conv2 - rhs

    def BC_D(e, k, f, norm=1.0):
        x = x_BC[e]
        return model(x)[:, k] - create_rhs(x, f, noise[e][k]) / norm

    def BC_IN(x, k, f, norm=1.0):
        return model(x)[:, k] - create_rhs(x, f) / norm

    def at_subset(name, k, sol, norm):
        return model(at[name])[:, k] - sol[ix[name]] / norm

    LMS = ns.LossMeanSquares
    losses = []
    if use_pdelosses:
        losses += [
            LMS("PDE_MASS", lambda: PDE_MASS(x_PDE), normalization=1e0,
                weight=1e-2),
            LMS("PDE_MOMU", lambda: PDE_MOM(x_PDE, 0, 0), normalization=1e4,
                weight=1e-2),
            LMS("PDE_MOMV", lambda: PDE_MOM(x_PDE, 1, 0), normalization=1e4,
                weight=1e-2),
        ]
    if use_boundaryc:
        for e in EDGES:
            lid = U if e == "y1" else 0
            losses += [
                LMS(f"BCD_u_{e}", lambda e=e, f=lid: BC_D(e, 0, f, vel_max)),
                LMS(f"BCD_v_{e}", lambda e=e: BC_D(e, 1, 0, vel_max)),
            ]
    if use_initialco:
        losses += [
            LMS("CI_u", lambda: BC_IN(x_CI, 0, 0, vel_max)),
            LMS("CI_v", lambda: BC_IN(x_CI, 1, 0, vel_max)),
            LMS("CI_p", lambda: BC_IN(x_CI, 2, 0, p_max)),
        ]
    if coll_velocity:
        losses += [
            LMS("COL_u", lambda: at_subset("col", 0, u_num, vel_max)),
            LMS("COL_v", lambda: at_subset("col", 1, v_num, vel_max)),
        ]
    if coll_pressure:
        losses += [LMS("COL_p", lambda: at_subset("col", 2, p_num, p_max))]
    loss_test = [
        LMS("u_fit", lambda: at_subset("test", 0, u_num, vel_max)),
        LMS("v_fit", lambda: at_subset("test", 1, v_num, vel_max)),
        LMS("p_fit", lambda: at_subset("test", 2, p_num, p_max)),
    ]
    return ns.OptimizationProblem(model.variables, losses, loss_test)


def from_arrays(arrays: dict, params, series, device=None,
                sizes: dict = DEFAULT_SIZES, **flags):
    """(pb, model) from given boundary / initial points and noise (numpy,
    the names of ``POINTS``, a noise None for none) and initial weights,
    e.g. the JAX package's draws, on the exact ``series``; the index
    subsets are drawn as ``main`` draws them; ``flags`` go to ``build``."""
    model = make_model(device, params=params)
    var = space_time_grid()
    pts = {k: None if arrays[k] is None else as_points(arrays[k], model)
           for k in POINTS}
    return build(model, var, series, sample_subsets(len(var), sizes), pts,
                 **flags), model


def sample_points(generator: torch.Generator, model, sizes: dict,
                  use_noise: bool = True) -> dict:
    """``num_BC`` points in (t, edge) on each edge (x = 0, x = 1, y = 0,
    y = 1), ``num_CI`` at t = 0 and, with ``use_noise``, 0.1·N(0, 1) noise
    on each edge's u and v values."""
    box = lambda n, lo, hi: sample_box(generator, n, lo, hi,
                                       dtype=model.dtype).to(model.device)
    n_bc = sizes["num_BC"]
    pts = {"x_BC_x0": box(n_bc, [0, A, A], [T, A, B]),
           "x_BC_x1": box(n_bc, [0, B, A], [T, B, B]),
           "x_BC_y0": box(n_bc, [0, A, A], [T, B, A]),
           "x_BC_y1": box(n_bc, [0, A, B], [T, B, B]),
           "x_CI": box(sizes["num_CI"], [0, A, A], [0, B, B])}
    for e in EDGES:
        for c in "uv":
            pts[f"noise_{e}_{c}"] = (
                generate_noise(generator, n_bc, 1e-1, dtype=model.dtype)
                .to(model.device) if use_noise else None)
    return pts


def exact_slice(csv: dict, t: float, shape) -> list:
    """The regular-grid csv's (u, v, p) at time ``t`` (the rows within
    dt/4 of it), the pressure recentred."""
    sel = (csv["t"] >= t - DT / 4) & (csv["t"] <= t + DT / 4)
    p = csv["p"][sel].reshape(shape)
    return [csv["ux"][sel].reshape(shape), csv["uy"][sel].reshape(shape),
            p - np.mean(p)]


def main(epochs: int = 5000, use_noise: bool = True,
         second_round: str = "scipy", save_plots: bool = True,
         out_dir: str = None, num_PDE: int = 10000, num_BC: int = 5000,
         num_CI: int = 9000, num_col: int = 1000, num_pres: int = 2500,
         num_test: int = 7500, use_pdelosses: bool = True,
         use_boundaryc: bool = True, use_initialco: bool = True,
         coll_velocity: bool = True, coll_pressure: bool = True,
         device=None):
    """Train from seed ``SEED`` (weights, then boundary / initial points and
    noise, from one generator) on ``OUT/data/UnsteadyCase`` and write
    ``OUT/Images``; returns (pb, model)."""
    if out_dir is None:
        raise ValueError("out_dir is required")
    device = config.resolve_device(device)
    sizes = dict(num_PDE=num_PDE, num_BC=num_BC, num_CI=num_CI,
                 num_col=num_col, num_pres=num_pres, num_test=num_test)
    flags = dict(use_pdelosses=use_pdelosses, use_boundaryc=use_boundaryc,
                 use_initialco=use_initialco, coll_velocity=coll_velocity,
                 coll_pressure=coll_pressure)
    folder, series = load_series(out_dir, device)
    var = space_time_grid()
    gen = torch.Generator().manual_seed(SEED)
    model = make_model(device, generator=gen)
    pb = build(model, var, series, sample_subsets(len(var), sizes),
               sample_points(gen, model, sizes, use_noise), **flags)

    images = os.path.join(out_dir, "Images")
    os.makedirs(images, exist_ok=True)
    pb.callbacks.append(ns.utils.HistoryPlotCallback(
        frequency=100, gui=False,
        filename=os.path.join(images, f"{problem_name}_LossTrend.png"),
        filename_history=os.path.join(
            images, f"{problem_name}_history_loss.json")))
    train(pb, epochs, second_round)

    if save_plots and utils.has_module("matplotlib"):
        vel_max, p_max = scales(series)
        n_time_stamp = 4
        grid_x, grid_y = np.meshgrid(np.linspace(A, B, 100),
                                     np.linspace(A, B, 100))
        csv = io.read_regular_csv(os.path.join(folder,
                                               generate.UNSTEADY_CSV))
        for i, t in enumerate(np.linspace(0, T, n_time_stamp + 1)):
            tq = T - DT if t == T else t
            exact = exact_slice(csv, tq, grid_x.shape)
            grid = np.stack([np.full(grid_x.size, tq), grid_x.ravel(),
                             grid_y.ravel()], axis=-1)
            with torch.no_grad():
                out = model(grid).cpu().numpy()
            pinn = [out[:, c].reshape(grid_x.shape) * s
                    for c, s in enumerate((vel_max, vel_max, p_max))]
            ns.viz.contour_compare(
                grid_x, grid_y, exact, pinn,
                titles=("u-velocity", "v-velocity", "Pressure"),
                problem_name="Solutions when t = {0:.4f}".format(tq),
                filename=os.path.join(
                    images, "{}_Graphic_{}_of_{}.jpg".format(
                        problem_name, i + 1, n_time_stamp + 1)))

    final_test = {n: d["log"][-1]
                  for n, d in pb.history.losses_test.items() if d["log"]}
    print("\nSIMULATION OPTIONS RECAP...")
    print("\tEpochs             ->", epochs)
    print("\tPinns points       ->", num_PDE)
    print("\tBoundary points    ->", num_BC)
    print("\tInitial  points    ->", num_CI)
    print("\tCollocation points ->", num_col)
    print("\tPressure points    ->", num_pres)
    print("\tTest points        ->", num_test)
    print("final test losses:", {k: f"{v:.3e}" for k, v in
                                 final_test.items()})
    return pb, model


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True,
                    help="data (OUT/data/UnsteadyCase) and Images")
    ap.add_argument("--epochs", type=int, default=5000)
    ap.add_argument("--second-round", default="scipy",
                    choices=["scipy", "jax", "jax-bfgs", "none"])
    ap.add_argument("--no-noise", action="store_true")
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    main(epochs=args.epochs, use_noise=not args.no_noise,
         second_round=args.second_round, save_plots=not args.no_plots,
         out_dir=args.out_dir, device=args.device)


if __name__ == "__main__":
    cli()
