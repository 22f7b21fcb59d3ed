"""Coronary stenosis flow: the steady Navier–Stokes case on the gmsh mesh,
as examples/Coronary_Flow/coronary_flow_steady.py.

The domain nodes are the vertices of the stenosis mesh ``coroParam.msh``
(10,833 nodes), the labeled boundary points come from ``bpoints.npy``
(flags 0 NOSL, 1 INF, 2 OUT1, 3 OUT2) and the exact fields from the P1-FEM
oracle (:mod:`tpinn_torch.oracles.coronary`, on the host) on the same
mesh, made once into ``BASE/data/SteadyCase`` (``SteadyCase_r<k>`` with
``--refine k``) and reused.  Where the base dir has no mesh or no
boundary points, the copies committed with the package are taken.  The
losses:

* the three PDE residuals at weights 1e2 (mass) / 1e1 / 1e1 (momentum),
  ν = 1e4·μ/ρ, on one ResidualBundle (the closed-form Taylor streams, or
  kernel 5 under ``TPINN_USE_PALLAS=1``; not the fused kernels 1/2, as in
  the example);
* no slip on the wall and the rotated parabolic inflow profile (Dirichlet,
  optionally with boundary noise);
* traction-free outflows at weight 1e-3, on OUT1 with the oblique
  unnormalized normal n = (2, 1) and on OUT2 with n = (1, 0), each on its
  own ResidualBundle;
* noisy velocity fitting; the three test losses on the test split.

Every training loss carries its ``point_residual`` for the LM round's
per-point Gram.  Adam at lr 1e-2 for 100 epochs, then the second round of
``driver.run_second_round`` (default "scipy", the on-device dense BFGS);
``--resume FOLDER`` skips Adam and continues a saved run (the LM round
does not adopt a BFGS-tagged state).  The artifacts: Model.json, the
weights, History_Loss.json, checkpoint.pkl, ``sol_pinn`` (h5 with h5py,
else npz: u_pinn, v_pinn, p_pinn at every node, in physical units),
Test_Options.txt, and where matplotlib exists Graphic.jpg and the loss
trends.  Run with::

    python -m tpinn_torch.cases.coronary_flow_steady --base-dir OUT \
        [--epochs N] [--second-round scipy|jax|jax-bfgs|lm|adam|none] \
        [--resume OUT/Test_Case_#001] [--refine 1] [--noise-bnd 0.01] \
        [--scratch] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from tpinn_torch import checkpoint, config, experiment, utils, viz
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import SECOND_ROUND_CHOICES, resume_run, run_second_round
from tpinn_torch.geometry import Normalization, generate_noise, split_indices
from tpinn_torch.losses import LossMeanSquares
from tpinn_torch.models import MLP
from tpinn_torch.optimize import minimize
from tpinn_torch.optimizers import Adam
from tpinn_torch.oracles import coronary as coro
from tpinn_torch.oracles import io
from tpinn_torch.oracles.mesh import read_gmsh
from tpinn_torch.pipeline import (
    NSPhysics,
    ResidualBundle,
    dirichlet_point_residual,
    dirichlet_residual,
    mass_residual,
    momentum_residual,
    neumann_point_residual,
    neumann_residual,
    pde_point_residuals,
)
from tpinn_torch.problem import OptimizationProblem
from tpinn_torch.utils import CheckpointCallback, HistoryPlotCallback

PRM = coro.CoronaryParams()
ADAM_EPOCHS = 100
N_OUT1 = (2.0, 1.0)  # oblique, unnormalized
N_OUT2 = (1.0, 0.0)
SOL_NAMES = ("u_pinn", "v_pinn", "p_pinn")
# the noisy Dirichlet groups, in the order their noise is drawn
NOISY_GROUPS = ((0, "NOSL"), (1, "NOSL"), (0, "INF"), (1, "INF"))

LOSS_GROUPS = {
    "Test_Loss": ["u_test", "v_test", "p_test"],
    "Equations_Residuals": ["PDE_MASS", "PDE_MOMU", "PDE_MOMV"],
    "Boundary_Dirichlet": ["BCD_u_NS", "BCD_v_NS", "BCD_u_IN", "BCD_v_IN"],
    "Boundary_Neumann": ["BCN_u_OUT1", "BCN_v_OUT1", "BCN_u_OUT2", "BCN_v_OUT2"],
    "Fitting Loss": ["Fit_u", "Fit_v"],
}


def default_options() -> SimulationOptions:
    # the reference run: 3000 PDE / 800 BC / 50 vel fit, 1 % noise
    return SimulationOptions(
        epochs=30000, noise_fit=0.01, noise_bnd=0.0,
        n_pde=3000, n_bc=800, n_ic=0, n_vel=50, n_pres=0, n_test=2000,
    )


def asset_paths(cwd: str):
    """(mesh, boundary points) in ``cwd``: copied there from the package's
    committed files where missing.  A mesh of another origin without its
    boundary points gets them derived from it (``generate_bpoints``)."""
    msh = os.path.join(cwd, "coroParam.msh")
    bpts = os.path.join(cwd, "bpoints.npy")
    os.makedirs(cwd, exist_ok=True)
    if not os.path.exists(msh):
        shutil.copy(coro.MESH_PATH, msh)
    if not os.path.exists(bpts):
        if coro.sha256(msh) == coro.MESH_SHA256:
            shutil.copy(coro.BPOINTS_PATH, bpts)
        else:
            # nodes of a regenerated mesh sit on the exact geometry through
            # interpolation arithmetic: the looser predicate tolerance
            np.save(bpts, coro.generate_bpoints(msh, tol=1e-9))
    return msh, bpts


def load_data(cwd: str, refine: int = 0) -> dict:
    """The exact fields at the mesh nodes and the labeled boundary points:
    {nodes (M, 2), u, v, p (M,), bnd {NOSL, INF, OUT1, OUT2: (K, 2)}}, the
    oracle's data made first where missing."""
    msh, bpts = asset_paths(cwd)
    folder = coro.generate_coronary(os.path.join(cwd, "data"), msh, bpts,
                                    PRM, refine=refine)
    path = coro.steady_fields_path(folder)
    u, v, p = io.read_fields(path)
    return {"nodes": io.read_mesh_geometry(path), "u": u, "v": v, "p": p,
            "bnd": io.load_bpoints(bpts)}


def draw(generator: torch.Generator, data: dict,
         opts: SimulationOptions) -> dict:
    """The run's random draws from ``generator``: the node splits
    {PDE, Vel, Pres, Test}, the fit noise of u and v and, with
    ``opts.noise_bnd``, the noise of the Dirichlet targets (NOISY_GROUPS
    order), as host arrays."""
    idx = split_indices(generator, len(data["nodes"]), opts.n_pts)
    noise = lambda n, factor: generate_noise(
        generator, n, factor, dtype=torch.float64).numpy()
    fit_noise = [noise(len(idx["Vel"]), opts.noise_fit) for _ in range(2)]
    bnd_noise = {}
    if opts.noise_bnd:
        for comp, grp in NOISY_GROUPS:
            bnd_noise[(comp, grp)] = noise(len(data["bnd"][grp]),
                                           opts.noise_bnd)
    return {"idx": idx, "fit_noise": fit_noise, "bnd_noise": bnd_noise}


def extents(nodes: np.ndarray):
    """The mesh's bounding box, the model's input extents."""
    return [(float(nodes[:, 0].min()), float(nodes[:, 0].max())),
            (float(nodes[:, 1].min()), float(nodes[:, 1].max()))]


def make_model(device, params=None, input_extents=None, seed: int = 0):
    """The case's 2-32-32-32-3 tanh MLP (layer 0 folds ``input_extents``,
    by default the committed mesh's bounding box); ``params`` (numpy, the
    JAX package's layout) replace the initial weights."""
    if input_extents is None:
        input_extents = extents(read_gmsh(coro.MESH_PATH).nodes)
    model = MLP(2, 3, width=32, depth=3, seed=seed, device=device,
                input_extents=input_extents)
    if params is not None:
        model.set_params(params_from_numpy(params, dtype=model.dtype))
    return model


def build(model, arrays: dict, fit_velocity: bool = True):
    """(pb, norm): the optimization problem on ``arrays`` (``load_data``'s
    and ``draw``'s keys together) with tpinn's 13 training losses (11
    without velocity fitting) and 3 test losses, and the spread
    normalization of the exact fields."""
    dev, dtype = model.device, model.dtype
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    dom_grid = t(arrays["nodes"])
    u_ex, v_ex, p_ex = (t(arrays[k]) for k in ("u", "v", "p"))
    norm = Normalization(u_ex, v_ex, p_ex)
    nv, npre = norm.norm_vel, norm.norm_pre
    sol_norm = [u_ex / nv, v_ex / nv, p_ex / npre]
    idx = {k: torch.as_tensor(np.array(v), dtype=torch.long, device=dev)
           for k, v in arrays["idx"].items()}

    bnd = {k: t(v) for k, v in arrays["bnd"].items()}
    u_in, v_in = coro.inflow_profile(np.asarray(arrays["bnd"]["INF"]), PRM)
    n_nosl = bnd["NOSL"].shape[0]
    bnd_val = {
        0: {"NOSL": torch.zeros(n_nosl, dtype=dtype, device=dev),
            "INF": t(u_in) / nv},
        1: {"NOSL": torch.zeros(n_nosl, dtype=dtype, device=dev),
            "INF": t(v_in) / nv},
    }
    for (comp, grp), noise in arrays.get("bnd_noise", {}).items():
        bnd_val[comp][grp] = bnd_val[comp][grp] + t(noise)
    iv = idx["Vel"]
    sol_noise = [sol_norm[c][iv] + t(arrays["fit_noise"][c]) for c in (0, 1)]

    physics = NSPhysics(conv=1.0, visc=PRM.ni)
    x_pde = dom_grid[idx["PDE"]]
    pde_bundle = ResidualBundle(model, x_pde)
    out1_bundle = ResidualBundle(model, bnd["OUT1"])
    out2_bundle = ResidualBundle(model, bnd["OUT2"])
    p_mass, p_momu, p_momv = pde_point_residuals(model, physics, norm)

    def dir_pr(comp, x, rhs):
        r = torch.broadcast_to(torch.as_tensor(rhs, dtype=x.dtype,
                                               device=x.device),
                               (x.shape[0],))
        return (dirichlet_point_residual(model, comp), (x, r))

    def neu_pr(comp, x, n):
        z = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return (neumann_point_residual(model, comp, n, physics, norm), (x, z))

    def dirichlet(name, comp, grp):
        x, rhs = bnd[grp], bnd_val[comp][grp]
        return LMS(name, lambda: dirichlet_residual(model, x, comp, rhs),
                   point_residual=dir_pr(comp, x, rhs))

    def neumann(name, comp, bundle, grp, n):
        return LMS(name, lambda: neumann_residual(bundle, comp, n, physics,
                                                  norm),
                   weight=1e-3, point_residual=neu_pr(comp, bnd[grp], n))

    LMS = LossMeanSquares
    losses = [
        LMS("PDE_MASS", lambda: mass_residual(pde_bundle, norm), weight=1e2,
            point_residual=(p_mass, (x_pde,))),
        LMS("PDE_MOMU", lambda: momentum_residual(pde_bundle, 0, physics,
                                                  norm), weight=1e1,
            point_residual=(p_momu, (x_pde,))),
        LMS("PDE_MOMV", lambda: momentum_residual(pde_bundle, 1, physics,
                                                  norm), weight=1e1,
            point_residual=(p_momv, (x_pde,))),
        dirichlet("BCD_u_NS", 0, "NOSL"),
        dirichlet("BCD_v_NS", 1, "NOSL"),
        dirichlet("BCD_u_IN", 0, "INF"),
        dirichlet("BCD_v_IN", 1, "INF"),
        neumann("BCN_u_OUT1", 0, out1_bundle, "OUT1", N_OUT1),
        neumann("BCN_v_OUT1", 1, out1_bundle, "OUT1", N_OUT1),
        neumann("BCN_u_OUT2", 0, out2_bundle, "OUT2", N_OUT2),
        neumann("BCN_v_OUT2", 1, out2_bundle, "OUT2", N_OUT2),
    ]
    x_vel = dom_grid[iv]
    if fit_velocity:
        losses += [
            LMS("Fit_u", lambda: dirichlet_residual(model, x_vel, 0,
                                                    sol_noise[0]),
                point_residual=dir_pr(0, x_vel, sol_noise[0])),
            LMS("Fit_v", lambda: dirichlet_residual(model, x_vel, 1,
                                                    sol_noise[1]),
                point_residual=dir_pr(1, x_vel, sol_noise[1])),
        ]
    it = idx["Test"]
    x_test = dom_grid[it]
    tst = [sol_norm[c][it] for c in range(3)]
    losses_test = [
        LMS(name, (lambda c=c: dirichlet_residual(model, x_test, c, tst[c])))
        for c, name in enumerate(("u_test", "v_test", "p_test"))
    ]
    return OptimizationProblem(model.variables, losses, losses_test), norm


def train(pb, second_round: str, epochs: int, adam: bool = True,
          adam_lr: float = 1e-2) -> None:
    """Adam at lr 1e-2 for 100 epochs (unless ``adam`` is off, as on a
    resume), then ``second_round`` for ``epochs`` iterations."""
    if adam:
        minimize(pb, "keras", Adam(learning_rate=1e-2),
                 num_epochs=ADAM_EPOCHS)
    run_second_round(pb, second_round, epochs, adam_lr=adam_lr)


def save_artifacts(folder, pb, model, norm, data, opts) -> None:
    """The run folder's files (see the module docstring)."""
    checkpoint.save_experiment(folder, model, pb.history,
                               opt_state=pb.last_opt_state)
    nodes = data["nodes"]
    with torch.no_grad():
        out = model(torch.as_tensor(nodes, dtype=model.dtype,
                                    device=model.device)).cpu().numpy()
    scales = (norm.norm_vel, norm.norm_vel, norm.norm_pre)
    pinn = [out[:, c] * scales[c] for c in range(3)]
    io.write_fields(os.path.join(folder, "sol_pinn" + io.fields_ext()),
                    *pinn, names=SOL_NAMES)
    if utils.has_module("matplotlib"):
        viz.tricontour_compare(
            nodes[:, 0], nodes[:, 1], (data["u"], data["v"], data["p"]),
            pinn, problem_name="Coronary_Flow",
            filename=os.path.join(folder, "Graphic.jpg"))
        viz.plot_loss_groups(
            pb.history.to_dict(), LOSS_GROUPS,
            filename=os.path.join(folder, "Loss_Trend_Reduced.png"))
    experiment.write_recap(folder, "Coronary_Flow", opts.epochs, opts.n_pts,
                           noise_fit=opts.noise_fit, noise_bnd=opts.noise_bnd,
                           echo=False)


def main(epochs=None, save_results=True, base_dir=None, second_round="scipy",
         seed=0, resume_from=None, refine=0, noise_bnd=None, adam_lr=1e-2, *,
         device=None):
    """Train the case into a run folder under ``base_dir`` (default: the
    working directory), or continue the run in ``resume_from``; returns
    (pb, model)."""
    device = config.resolve_device(device)
    cwd = base_dir or os.getcwd()
    opts_file = os.path.join(cwd, "simulation_options.txt")
    opts = (SimulationOptions.from_file(opts_file)
            if os.path.exists(opts_file) else default_options())
    if epochs is not None:
        opts.epochs = epochs
    if noise_bnd is not None:  # the reference run #123 uses 0.01
        opts.noise_bnd = noise_bnd

    data = load_data(cwd, refine)
    arrays = {**data, **draw(torch.Generator().manual_seed(seed), data, opts)}
    model = make_model(device, input_extents=extents(data["nodes"]),
                       seed=seed)
    pb, norm = build(model, arrays, fit_velocity=opts.fit_velocity)

    folder = (resume_from if resume_from is not None
              else experiment.prepare_folder(cwd, save_results))
    if resume_from is not None:
        resume_run(pb, resume_from)
    pb.callbacks.append(HistoryPlotCallback(
        frequency=100, gui=False,
        filename=os.path.join(folder, "Loss_Trend_Full.png"),
        filename_history=os.path.join(folder, "History_Loss.json")))
    pb.callbacks.append(CheckpointCallback(
        os.path.join(folder, "checkpoint.pkl"), frequency=100))
    train(pb, second_round, opts.epochs, adam=resume_from is None,
          adam_lr=adam_lr)

    save_artifacts(folder, pb, model, norm, data, opts)
    final = {k: v["log"][-1] for k, v in pb.history.losses_test.items()}
    print("final test losses:", final)
    return pb, model


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-dir", default=None,
                    help="run folders, mesh, data and simulation_options.txt "
                         "(default: the working directory)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="second-round iterations (default: the options')")
    ap.add_argument("--second-round", default="scipy",
                    choices=SECOND_ROUND_CHOICES,
                    help="'scipy', 'jax-bfgs' and 'bfgs' run the on-device "
                         "dense BFGS, whose carry a checkpoint resumes; "
                         "'jax' the on-device L-BFGS; 'scipy-parity' / "
                         "'scipy-host' the host scipy BFGS; 'lm' "
                         "Levenberg-Marquardt; 'adam' the cosine-decay "
                         "Adam round")
    ap.add_argument("--scratch", action="store_true",
                    help="write into Last_Training instead of Test_Case_#NNN")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default=None, metavar="FOLDER",
                    help="continue the saved run in FOLDER: load its "
                         "weights, history and checkpoint, run only the "
                         "second round")
    ap.add_argument("--refine", type=int, default=0,
                    help="oracle mesh refinement levels (data folder "
                         "SteadyCase_r<k>)")
    ap.add_argument("--noise-bnd", type=float, default=None,
                    help="boundary-target noise factor (reference #123: 0.01)")
    ap.add_argument("--adam-lr", type=float, default=1e-2,
                    help="peak lr for --second-round adam (cosine decay)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    main(args.epochs, save_results=not args.scratch, base_dir=args.base_dir,
         second_round=args.second_round, seed=args.seed,
         resume_from=args.resume, refine=args.refine,
         noise_bnd=args.noise_bnd, adam_lr=args.adam_lr, device=args.device)


if __name__ == "__main__":
    cli()
