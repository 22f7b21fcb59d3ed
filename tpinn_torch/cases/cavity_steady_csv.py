"""The steady lid-driven cavity in the old script style: data from the
random-point csv, sliced by position, written in the tape style of the
reference's scripts.

* The csv ``navier-stokes_cavity_steady.csv`` (5,000 points; made by
  :func:`tpinn_torch.oracles.generate.generate_cavity_steady` into
  ``OUT/data/SteadyCase`` when missing) is cut in order into 50 PDE, 50
  collocation, 2,000 test and 100 pressure points; 50 boundary points are
  drawn on each edge.
* A 2-32-32-64-3 tanh MLP; the PDE losses at ``normalization=1e4,
  weight=1e-2``; u and v scaled by the largest velocity spread, p by the
  pressure spread.
* ``press_mode``: "Collocation" fits p at the pressure points (``COL_p``),
  "Mean" penalises |mean p| − mean p_exact there (``MEAN_p``, weight
  1e-6), "None" leaves the pressure free.
* Adam at lr 1e-2 for 100 epochs, then ``epochs`` iterations of the host
  scipy BFGS ("scipy"), the on-device dense BFGS ("jax-bfgs") or the
  on-device L-BFGS ("jax").
* ``save_mode`` writes ``OUT/Saved_Model/<name>.json`` and the weights
  (``<name>.h5``, or ``<name>.npz`` where h5py is missing); ``load_mode``
  reads them back and skips training.

Run with::

    python -m tpinn_torch.cases.cavity_steady_csv --out-dir OUT \
        [--epochs 100] [--second-round scipy|jax|jax-bfgs|none] \
        [--use-noise] [--press-mode Collocation|Mean|None] [--no-plots] \
        [--load NAME] [--save NAME] [--device cpu]

It writes ``OUT/Images/`` (the history JSON, and where matplotlib is
installed the loss trend and the contours against the regular-grid csv).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import tpinn_torch as ns
from tpinn_torch import config, utils
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.cases.poisson import as_points
from tpinn_torch.experimental.physics import tens_style as operator
from tpinn_torch.geometry import generate_noise, sample_box
from tpinn_torch.models import Model, model_from_json
from tpinn_torch.oracles import generate, io

problem_name = "Lid Driven Cavity - Steady"

DIM = 2
A, B = 0.0, 1.0
U = 500.0
SEED = 1  # the weights, points and noise; fixed, as in the reference
NUM_PDE, NUM_BC, NUM_COL, NUM_PRES, NUM_TEST = 50, 50, 50, 100, 2000
I_COL, I_TEST = NUM_PDE, NUM_PDE + NUM_COL
I_PRES = I_TEST + NUM_TEST
# the boundary points and noise (None: no noise); x_BCD_0 stacks the x0,
# x1 and y0 edges, and their noise vectors span it
POINTS = ("x_BC_x0", "x_BC_x1", "x_BC_y0", "x_BC_y1", "noise_x", "noise_y",
          "noise_x_up", "noise_y_up")
PRESS_MODES = ("Collocation", "Mean", "None")


def load_data(out_dir: str, device=None):
    """(folder, data): the random-point csv's columns x (N, 2), u, v, p,
    the csv made first where missing."""
    folder = generate.generate_cavity_steady(
        os.path.join(out_dir, "data"), U=U, n_solver=128, t_end=40.0,
        device=device)
    csv = io.read_regular_csv(os.path.join(folder,
                                           generate.STEADY_RANDOM_CSV))
    x = np.stack([csv["x"], csv["y"]], axis=-1)
    return folder, {"x": x, "u": csv["ux"], "v": csv["uy"], "p": csv["p"]}


def make_model(device, generator=None, params=None) -> Model:
    model = Model([2, 32, 32, 64, 3], activation="tanh", seed=SEED,
                  generator=generator, device=device,
                  input_extents=[(A, B), (A, B)])
    if params is not None:
        model.set_params(params_from_numpy(params, dtype=model.dtype))
    return model


def scales(data: dict):
    """(vel_max, p_max, p_mean): the largest velocity spread, the pressure
    spread over all points, the mean exact pressure at the pressure
    points."""
    u, v, p = data["u"], data["v"], data["p"]
    vel_max = float(max(np.max(u) - np.min(u), np.max(v) - np.min(v)))
    return (vel_max, float(np.max(p) - np.min(p)),
            float(np.mean(p[I_PRES:I_PRES + NUM_PRES])))


def build(model, data: dict, pts: dict, collocation: bool = True,
          press_mode: str = "Collocation"):
    """The optimization problem on the csv ``data`` and the boundary
    points and noise ``pts`` (the names of ``POINTS``)."""
    if press_mode not in PRESS_MODES:
        raise ValueError(f"press_mode {press_mode!r}; choices: "
                         f"{PRESS_MODES}")
    dtype = model.dtype
    x_num = as_points(data["x"], model)
    x_PDE = x_num[:NUM_PDE]
    x_col = x_num[I_COL:I_TEST]
    x_test = x_num[I_TEST:I_PRES]
    x_pres = x_num[I_PRES:I_PRES + NUM_PRES]
    x_BC_x0, x_BC_x1, x_BC_y0, x_BC_y1 = (pts[k] for k in POINTS[:4])
    noise_x, noise_y, noise_x_up, noise_y_up = (pts[k] for k in POINTS[4:])
    vel_max, p_max, p_mean = scales(data)
    sols = {k: as_points(data[k], model) for k in ("u", "v", "p")}

    def create_rhs(x, force, noise=None):
        rhs = torch.zeros(x.shape[0], dtype=dtype, device=x.device)
        if isinstance(force, (int, float)) and force:
            rhs = rhs + force
        if noise is not None:
            rhs = rhs + noise
        return rhs

    # each of the x0 / x1 / y0 losses sees the first NUM_BC entries of the
    # noise vector that spans all three edges, as the reference
    slc = lambda noise: None if noise is None else noise[:NUM_BC]

    def PDE_MASS(x):
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x)
            u_vect = model(x)[:, 0:2] * vel_max
            div = operator.divergence_vector(tape, u_vect, x, DIM)
        return div

    def PDE_MOM(x, k, force):
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(x)
            u_vect = model(x)
            p = u_vect[:, 2] * p_max
            u_eq = u_vect[:, k] * vel_max
            dp = operator.gradient_scalar(tape, p, x)[:, k]
            lapl_eq = operator.laplacian_scalar(tape, u_eq, x, DIM)
            du_x = operator.gradient_scalar(tape, u_eq, x)[:, 0]
            du_y = operator.gradient_scalar(tape, u_eq, x)[:, 1]
            conv1 = vel_max * u_vect[:, 0] * du_x
            conv2 = vel_max * u_vect[:, 1] * du_y
        rhs = create_rhs(x, force)
        return -lapl_eq + dp + conv1 + conv2 - rhs

    def BC_D(x, k, f, norm=1.0, noise=None):
        return model(x)[:, k] - create_rhs(x, f, noise) / norm

    def col_velocity(x, k, sol, norm):
        return model(x)[:, k] - sol[I_COL:I_TEST] / norm

    def col_pressure(x, sol, norm):
        return model(x)[:, 2] - sol[I_PRES:I_PRES + NUM_PRES] / norm

    def exact_value(x, k, sol, norm):
        return model(x)[:, k] - sol[I_TEST:I_PRES] / norm

    def PRESS_MEAN(x, p, norm):
        uk_mean = torch.abs(torch.mean(model(x)[:, 2]))
        return uk_mean - create_rhs(x, p / norm)

    u_num, v_num, p_num = sols["u"], sols["v"], sols["p"]
    LMS = ns.LossMeanSquares
    losses = [
        LMS("PDE_MASS", lambda: PDE_MASS(x_PDE), normalization=1e4,
            weight=1e-2),
        LMS("PDE_MOMU", lambda: PDE_MOM(x_PDE, 0, 0), normalization=1e4,
            weight=1e-2),
        LMS("PDE_MOMV", lambda: PDE_MOM(x_PDE, 1, 0), normalization=1e4,
            weight=1e-2),
        LMS("BCD_u_x0", lambda: BC_D(x_BC_x0, 0, 0, vel_max, slc(noise_x))),
        LMS("BCD_v_x0", lambda: BC_D(x_BC_x0, 1, 0, vel_max, slc(noise_y))),
        LMS("BCD_u_x1", lambda: BC_D(x_BC_x1, 0, 0, vel_max, slc(noise_x))),
        LMS("BCD_v_x1", lambda: BC_D(x_BC_x1, 1, 0, vel_max, slc(noise_y))),
        LMS("BCD_u_y0", lambda: BC_D(x_BC_y0, 0, 0, vel_max, slc(noise_x))),
        LMS("BCD_v_y0", lambda: BC_D(x_BC_y0, 1, 0, vel_max, slc(noise_y))),
        LMS("BCD_u_y1", lambda: BC_D(x_BC_y1, 0, U, vel_max, noise_x_up)),
        LMS("BCD_v_y1", lambda: BC_D(x_BC_y1, 1, 0, vel_max, noise_y_up)),
    ]
    if collocation:
        losses += [
            LMS("COL_u", lambda: col_velocity(x_col, 0, u_num, vel_max)),
            LMS("COL_v", lambda: col_velocity(x_col, 1, v_num, vel_max)),
        ]
    if press_mode == "Collocation":
        losses += [LMS("COL_p", lambda: col_pressure(x_pres, p_num, p_max))]
    elif press_mode == "Mean":
        losses += [LMS("MEAN_p", lambda: PRESS_MEAN(x_pres, p_mean, p_max),
                       weight=1e-6)]
    loss_test = [
        LMS("u_fit", lambda: exact_value(x_test, 0, u_num, vel_max)),
        LMS("v_fit", lambda: exact_value(x_test, 1, v_num, vel_max)),
        LMS("p_fit", lambda: exact_value(x_test, 2, p_num, p_max)),
    ]
    return ns.OptimizationProblem(model.variables, losses, loss_test)


def from_arrays(arrays: dict, params, data: dict, device=None, **kw):
    """(pb, model) from given boundary points and noise (numpy, the names
    of ``POINTS``, a noise None for none), initial weights and csv data,
    e.g. the JAX package's draws; ``kw`` goes to ``build``."""
    model = make_model(device, params=params)
    pts = {k: None if arrays[k] is None else as_points(arrays[k], model)
           for k in POINTS}
    return build(model, data, pts, **kw), model


def sample_points(generator: torch.Generator, model,
                  use_noise: bool = False) -> dict:
    """NUM_BC points on each edge (x = 0, x = 1, y = 0, y = 1) and, with
    ``use_noise``, 0.1·N(0, 1) noise on the Dirichlet values."""
    box = lambda lo, hi: sample_box(generator, NUM_BC, lo, hi,
                                    dtype=model.dtype).to(model.device)
    pts = {"x_BC_x0": box([A, A], [A, B]), "x_BC_x1": box([B, A], [B, B]),
           "x_BC_y0": box([A, A], [B, A]), "x_BC_y1": box([A, B], [B, B])}
    for k, n in (("noise_x", 3 * NUM_BC), ("noise_y", 3 * NUM_BC),
                 ("noise_x_up", NUM_BC), ("noise_y_up", NUM_BC)):
        pts[k] = (generate_noise(generator, n, 1e-1, dtype=model.dtype)
                  .to(model.device) if use_noise else None)
    return pts


def train(pb, epochs: int, second_round: str = "scipy") -> None:
    """Adam at lr 1e-2 for 100 epochs, then ``epochs`` iterations of the
    host scipy BFGS ("scipy"), the on-device dense BFGS ("jax-bfgs"), none
    ("none") or the on-device L-BFGS (any other name)."""
    ns.minimize(pb, "keras", ns.optimizers.Adam(learning_rate=1e-2),
                num_epochs=100)
    if second_round == "scipy":
        ns.minimize(pb, "scipy", "BFGS", num_epochs=epochs)
    elif second_round == "jax-bfgs":
        ns.minimize(pb, "jax", "BFGS", num_epochs=epochs)
    elif second_round != "none":
        ns.minimize(pb, "jax", "L-BFGS", num_epochs=epochs)


def weights_path(saved_dir: str, name: str, saving: bool) -> str:
    """``name``'s weights file in ``saved_dir``: ``.h5`` where h5py is
    installed (to read, where that file exists), else ``.npz``."""
    stem = os.path.join(saved_dir, name)
    if utils.has_module("h5py") and (saving or os.path.exists(stem + ".h5")):
        return stem + ".h5"
    return stem + ".npz"


def main(epochs: int = 100, use_noise: bool = False, collocation: bool = True,
         press_mode: str = "Collocation", second_round: str = "scipy",
         save_plots: bool = True, out_dir: str = None,
         load_mode: bool = False, save_mode: bool = False,
         model_name_load: str = "", model_name_save: str = "", device=None):
    """Train from seed ``SEED`` (weights, then boundary points and noise,
    from one generator) on ``OUT/data/SteadyCase`` and write ``OUT/Images``
    (and with ``save_mode`` ``OUT/Saved_Model``); with ``load_mode`` the saved
    model is read back instead of training.  Returns (pb, model)."""
    if out_dir is None:
        raise ValueError("out_dir is required")
    device = config.resolve_device(device)
    folder, data = load_data(out_dir, device)
    gen = torch.Generator().manual_seed(SEED)
    model = make_model(device, generator=gen)
    pb = build(model, data, sample_points(gen, model, use_noise),
               collocation=collocation, press_mode=press_mode)
    vel_max, p_max, _ = scales(data)

    images = os.path.join(out_dir, "Images")
    os.makedirs(images, exist_ok=True)
    saved_dir = os.path.join(out_dir, "Saved_Model")
    if not load_mode:
        pb.callbacks.append(ns.utils.HistoryPlotCallback(
            frequency=100, gui=False,
            filename=os.path.join(images, f"{problem_name}_LossTrend.png"),
            filename_history=os.path.join(
                images, f"{problem_name}_history_loss.json")))
        train(pb, epochs, second_round)
    if load_mode and model_name_load:
        with open(os.path.join(saved_dir, f"{model_name_load}.json")) as f:
            model = model_from_json(f.read(), device=device)
        model.load_weights(weights_path(saved_dir, model_name_load, False))
    if save_mode and model_name_save:
        os.makedirs(saved_dir, exist_ok=True)
        with open(os.path.join(saved_dir, f"{model_name_save}.json"),
                  "w") as f:
            f.write(model.to_json())
        model.save_weights(weights_path(saved_dir, model_name_save, True))

    if save_plots and utils.has_module("matplotlib"):
        grid_x, grid_y = np.meshgrid(np.linspace(A, B, 100),
                                     np.linspace(A, B, 100))
        csv = io.read_regular_csv(os.path.join(folder, generate.STEADY_CSV))
        exact = [csv[k].reshape(grid_x.shape) for k in ("ux", "uy", "p")]
        with torch.no_grad():
            out = model(np.stack([grid_x.ravel(), grid_y.ravel()],
                                 axis=-1)).cpu().numpy()
        pinn = [out[:, c].reshape(grid_x.shape) * s
                for c, s in enumerate((vel_max, vel_max, p_max))]
        ns.viz.contour_compare(
            grid_x, grid_y, exact, pinn,
            titles=("u-velocity", "v-velocity", "Pressure"),
            problem_name=problem_name,
            filename=os.path.join(images, f"{problem_name}_Contours.png"))

    final_test = {n: d["log"][-1]
                  for n, d in pb.history.losses_test.items() if d["log"]}
    print("\nSIMULATION OPTIONS RECAP...")
    print("\tEpochs             ->", epochs)
    print("\tPinns points       ->", NUM_PDE)
    print("\tBoundary points    ->", NUM_BC)
    print("\tCollocation points ->", NUM_COL)
    print("\tPressure points    ->", NUM_PRES)
    print("\tTest points        ->", NUM_TEST)
    with torch.no_grad():
        pm = float(torch.mean(model(data["x"][I_TEST:I_PRES])[:, 2]))
    print("\tPressure mean -> {:e}".format(pm))
    print("final test losses:", {k: f"{v:.3e}" for k, v in final_test.items()
                                 if v is not None})
    return pb, model


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True,
                    help="data (OUT/data/SteadyCase), Images and "
                         "Saved_Model")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--second-round", default="scipy",
                    choices=["scipy", "jax", "jax-bfgs", "none"])
    ap.add_argument("--use-noise", action="store_true")
    ap.add_argument("--press-mode", default="Collocation",
                    choices=list(PRESS_MODES))
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--load", default="", metavar="NAME")
    ap.add_argument("--save", default="", metavar="NAME")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    main(epochs=args.epochs, use_noise=args.use_noise,
         press_mode=args.press_mode, second_round=args.second_round,
         save_plots=not args.no_plots, out_dir=args.out_dir,
         load_mode=bool(args.load), model_name_load=args.load,
         save_mode=bool(args.save), model_name_save=args.save,
         device=args.device)


if __name__ == "__main__":
    cli()
