"""Config-driven standard case driver for rectangular Navier–Stokes cases.

``StandardNSDriver`` runs the reference drivers' shared stages once:

  1  experiment folder             → tpinn_torch.experiment
  2  simulation_options.txt        → tpinn_torch.config.SimulationOptions
  3  grid + index splits           → tpinn_torch.geometry
  4  exact solution on the grid    → CaseSpec.exact / exact_data
  5  spread normalization          → tpinn_torch.geometry.Normalization
  6  noise injection               → tpinn_torch.geometry.generate_noise
  7  losses                        → tpinn_torch.pipeline builders
  8  model                         → tpinn_torch.models.MLP
  9  training: the Adam round, then the second round (run_second_round)
 10  Model.json, weights, History_Loss.json, checkpoint.pkl → checkpoint
 11  contour figure exact vs PINN   → tpinn_torch.viz.contour_compare
 12  grouped loss-trend figure      → tpinn_torch.viz.plot_loss_groups
 13  Test_Options.txt recap         → tpinn_torch.experiment.write_recap

This port covers the steady case and the unsteady space-time case (input
(t, x, y), the grid t slowest, an ∂t term in the momentum residual, the
t = 0 losses IC_u/IC_v/IC_p and, with ``exact_data``, per-slice figures)
on one device with the Adam round and every second round of the JAX
package's routing table (``run_second_round``: dense BFGS, L-BFGS, host scipy, Levenberg–Marquardt
and the cosine-decay Adam round), the pressure gauge (a ``Fit_p`` or a
``PRESS_0`` loss), the run artifacts and ``train(resume_from=...)``, which
continues a saved run exactly (the BFGS carry comes back from
``checkpoint.pkl``).  The PDE losses of a plain tanh MLP go through the
one-pass fused objective (on a CUDA device one launch of the residual
kernel per Adam step and per BFGS trial), except in an LM-bound driver: LM
needs the stacked residual vector, so it keeps the unfused
``LossMeanSquares`` PDE losses on one shared ``ResidualBundle`` (kernel 5
under ``TPINN_USE_PALLAS=1``).
Every training loss carries its ``point_residual`` for the LM round's
per-point Gram.  ``from_arrays`` builds the driver from given grid, splits,
boundary data, fit targets and initial parameters, so a run can start from
exactly the data of another implementation.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpinn_torch import checkpoint as ckpt
from tpinn_torch import config, experiment, viz
from tpinn_torch.config import SimulationOptions
from tpinn_torch.geometry import (
    Normalization,
    generate_noise,
    initial_condition_points,
    rect_boundary_points,
    rect_grid,
    space_time_grid,
    split_indices,
)
from tpinn_torch.history import History
from tpinn_torch.losses import Loss, LossMeanSquares, PrecomputedMeanSquares
from tpinn_torch.models import MLP
from tpinn_torch.optimize import minimize
from tpinn_torch.optimizers import Adam, cosine_decay_schedule
from tpinn_torch.pipeline import (
    FusedNSWeightedObjective,
    NSPhysics,
    ResidualBundle,
    dirichlet_point_residual,
    dirichlet_residual,
    initial_condition_residual,
    mass_residual,
    momentum_residual,
    neumann_point_residual,
    neumann_residual,
    pde_point_residuals,
    pressure_mean_penalty,
    use_fused_pde_losses,
)
from tpinn_torch.problem import OptimizationProblem
from tpinn_torch.utils import CheckpointCallback, HistoryPlotCallback

BndValue = Union[float, Callable, None]

SECOND_ROUND_CHOICES = (
    "scipy", "scipy-parity", "scipy-host", "jax", "jax-bfgs", "bfgs",
    "lm", "jax-lm", "gn", "adam", "none",
)
LM_ROUNDS = ("lm", "jax-lm", "gn")
BFGS_ROUNDS = ("jax-bfgs", "bfgs")
HOST_ROUNDS = ("scipy-parity", "scipy-host")


def check_second_round(second_round: Optional[str]) -> None:
    """Raise ValueError for a name outside ``SECOND_ROUND_CHOICES``."""
    if second_round is not None and second_round not in SECOND_ROUND_CHOICES:
        raise ValueError(f"unknown second_round {second_round!r}; choices: "
                         f"{SECOND_ROUND_CHOICES}")


def run_second_round(pb: OptimizationProblem, second_round: Optional[str],
                     epochs: int, scipy_method: str = "BFGS",
                     adam_lr: float = 1e-2) -> None:
    """The one routing table for the second optimizer round, for
    ``epochs`` iterations, as the JAX package's:

    * "scipy": the resumable on-device dense BFGS (its carry checkpoints,
      where scipy keeps its state to itself); with a ``scipy_method``
      other than BFGS the on-device L-BFGS;
    * "scipy-parity" / "scipy-host": the host scipy round with
      ``scipy_method``;
    * "jax": the on-device L-BFGS;
    * "jax-bfgs" / "bfgs": the on-device dense BFGS;
    * "lm" / "jax-lm" / "gn": Levenberg–Marquardt;
    * "adam": Adam on the cosine-decay schedule from ``adam_lr`` over
      ``epochs`` steps to 1e-3 of it (round ``keras_Adam``);
    * "none" / None: nothing.

    Any other name raises ValueError (``check_second_round``)."""
    check_second_round(second_round)
    if second_round == "scipy":
        method = "BFGS" if scipy_method.upper() == "BFGS" else "L-BFGS"
        minimize(pb, "jax", method, num_epochs=epochs)
    elif second_round in HOST_ROUNDS:
        minimize(pb, "scipy", scipy_method, num_epochs=epochs)
    elif second_round == "jax":
        minimize(pb, "jax", "L-BFGS", num_epochs=epochs)
    elif second_round in BFGS_ROUNDS:
        minimize(pb, "jax", "BFGS", num_epochs=epochs)
    elif second_round in LM_ROUNDS:
        minimize(pb, "jax", "LM", num_epochs=epochs)
    elif second_round == "adam":
        schedule = cosine_decay_schedule(adam_lr, max(epochs, 1), alpha=1e-3)
        minimize(pb, "keras", Adam(schedule), num_epochs=epochs)


def resume_run(pb: OptimizationProblem, folder: str) -> None:
    """Load a saved run folder into ``pb`` to continue it: the weights
    (Weights.h5, else Weights.npz), then ``checkpoint.pkl`` where it is at
    least as new as the weights (its parameters, and its optimizer state on
    ``pb.resume_opt_state`` for the second round of the same kind to
    adopt), then History_Loss.json with ``pb``'s losses registered."""
    model = pb.model
    weights = ckpt.weights_file(folder)
    if weights is None:
        raise FileNotFoundError(f"{folder} holds no Weights.h5 or "
                                "Weights.npz")
    model.load_weights(weights)
    path = os.path.join(folder, "checkpoint.pkl")
    # a killed round leaves checkpoint.pkl ahead of the final weights;
    # save_experiment writes it just after them, possibly within one tick
    # of the file system's clock, so an equal time counts as newer
    if (os.path.exists(path)
            and os.path.getmtime(path) >= os.path.getmtime(weights)):
        state = ckpt.load_checkpoint(path)
        model.set_params([
            {k: torch.as_tensor(np.asarray(p[k]), dtype=model.dtype)
             for k in ("kernel", "bias")} for p in state["params"]])
        pb.resume_opt_state = state.get("opt_state")
    hist = os.path.join(folder, "History_Loss.json")
    if os.path.exists(hist):
        pb.history = History.load(hist)
        pb.history.register_losses(pb.losses, pb.losses_test)


@dataclasses.dataclass
class CaseSpec:
    """Declarative description of a rectangular Navier–Stokes PINN case."""

    name: str
    extents: Sequence[Tuple[float, float]]
    physics: NSPhysics = NSPhysics()
    grid_shape: Tuple[int, int] = (100, 100)
    # exact solution: callables (u, v, p)(points) -> (N,), or arrays on the
    # grid's rows (unsteady: one spatial slice after another, t slowest)
    exact: Optional[Tuple[Callable, Callable, Callable]] = None
    exact_data: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    # Dirichlet boundary values per component {0: {edge: value}, 1: {...}}
    # value: float | callable(points)->(N,) | None
    bnd_val: Optional[Dict[int, Dict[str, BndValue]]] = None
    # Neumann specs {(edge, component): direction}; rhs comes from bnd_val
    neumann: Dict[Tuple[str, int], object] = dataclasses.field(default_factory=dict)
    weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    unsteady: bool = False  # input (t, x, y), t in [0, time_horizon)
    time_horizon: float = 0.0
    dt: float = 0.0  # the grid's time step
    width: int = 32
    depth: int = 3
    # the pressure gauge: None, "fit" (a Fit_p loss on the pressure split)
    # or "mean" (a PRESS_0 penalty on |mean p|)
    pressure_gauge: Optional[str] = None
    # a steady grid of evenly spaced nodes, else of random x and y nodes
    uniform_mesh: bool = True

    @property
    def dim_in(self) -> int:
        return 3 if self.unsteady else 2

    def weight(self, key: str, default: float = 1.0) -> float:
        return float(self.weights.get(key, default))


class StandardNSDriver:
    def __init__(
        self,
        spec: CaseSpec,
        opts: SimulationOptions,
        base_dir: str = ".",
        save_results: bool = True,
        seed: int = 0,
        second_round: str = "scipy",
        scipy_method: str = "BFGS",
        adam_epochs: int = 100,
        adam_lr: float = 1e-2,
        device=None,
        dtype: Optional[torch.dtype] = None,
        arrays: Optional[dict] = None,
    ):
        check_second_round(second_round)
        if spec.pressure_gauge not in (None, "fit", "mean"):
            raise ValueError(f"unknown pressure_gauge "
                             f"{spec.pressure_gauge!r}; choices: None, "
                             "'fit', 'mean'")
        self.spec = spec
        self.opts = opts
        self.base_dir = base_dir
        self.save_results = save_results
        self.seed = seed
        self.second_round = second_round
        self.scipy_method = scipy_method
        self.adam_epochs = adam_epochs
        self.adam_lr = adam_lr
        self.device = config.resolve_device(device)
        self.dtype = dtype or config.get_dtype()
        self.folder: Optional[str] = None
        self.pb: Optional[OptimizationProblem] = None
        self._build(arrays)

    @classmethod
    def from_arrays(cls, spec: CaseSpec, opts: SimulationOptions, *,
                    dom_grid, idx_set: Dict[str, np.ndarray],
                    bnd_pts: Dict[str, np.ndarray],
                    bnd_val_num: Dict[int, Dict[str, np.ndarray]],
                    sol_noise: Sequence[np.ndarray], params: Sequence[dict],
                    ic_pts=None, **kw) -> "StandardNSDriver":
        """A driver on given data instead of its own random draws: the grid
        (N, d), the index splits {PDE, Vel, Pres, Test}, the boundary points
        per edge, the boundary values per component and edge, the noisy fit
        targets [u, v, p], the initial params (list of {kernel, bias}) and,
        unsteady, the t = 0 points (n_ic, 3)."""
        arrays = dict(dom_grid=dom_grid, idx_set=idx_set, bnd_pts=bnd_pts,
                      bnd_val_num=bnd_val_num, sol_noise=sol_noise,
                      params=params, ic_pts=ic_pts)
        return cls(spec, opts, arrays=arrays, **kw)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------ build
    def _build(self, arrays: Optional[dict]) -> None:
        spec, opts, dt = self.spec, self.opts, self.dtype
        gens = [torch.Generator().manual_seed(int(s)) for s in
                np.random.SeedSequence(self.seed).generate_state(6)]
        g_split, g_bnd, g_noise_b, g_noise_f, g_grid, g_ic = gens

        # stage 3: grid and splits
        if arrays is not None:
            dom_grid = torch.as_tensor(np.array(arrays["dom_grid"]), dtype=dt)
        elif spec.unsteady:
            # numpy's arange, as the reference: round(T/dt) slices that line
            # up with exact_data row for row
            (lx, ux), (ly, uy) = spec.extents
            n1, n2 = spec.grid_shape
            dom_grid = space_time_grid(
                *(torch.as_tensor(v, dtype=dt) for v in (
                    np.arange(0.0, spec.time_horizon, step=spec.dt),
                    np.linspace(lx, ux, n1 + 1), np.linspace(ly, uy, n2 + 1))))
        else:
            dom_grid = rect_grid(spec.extents, spec.grid_shape, dt,
                                 spec.uniform_mesh, g_grid)
        if arrays is not None:
            self.idx_set = {k: np.array(v) for k, v in arrays["idx_set"].items()}
        else:
            self.idx_set = split_indices(g_split, dom_grid.shape[0], opts.n_pts)
        self.dom_grid = dom_grid.to(self.device)

        # stage 4: exact solution on the grid
        if spec.exact_data is not None:
            fields = [torch.as_tensor(a, dtype=dt, device=self.device)
                      for a in spec.exact_data]
            if any(f.shape != (dom_grid.shape[0],) for f in fields):
                raise ValueError(
                    f"exact_data has {[tuple(f.shape) for f in fields]} "
                    f"values; the grid has {dom_grid.shape[0]} rows")
        elif spec.exact is not None:
            fields = [torch.as_tensor(f(self.dom_grid), dtype=dt,
                                      device=self.device) for f in spec.exact]
        else:
            raise ValueError("CaseSpec needs exact callables or exact_data")
        u_ex, v_ex, p_ex = fields
        self.exact_fields = (u_ex, v_ex, p_ex)

        # stage 5: normalization
        self.norm = Normalization(u_ex, v_ex, p_ex)
        nv, npre = self.norm.norm_vel, self.norm.norm_pre
        self.sol_norm = [u_ex / nv, v_ex / nv, p_ex / npre]

        # stage 6/7: boundary points and values (+ noise)
        if arrays is not None:
            self.bnd_pts = {k: self._tensor(v)
                            for k, v in arrays["bnd_pts"].items()}
            self.bnd_val_num = {c: {e: self._tensor(v) for e, v in d.items()}
                                for c, d in arrays["bnd_val_num"].items()}
        else:
            horizon = spec.time_horizon if spec.unsteady else None
            self.bnd_pts = {k: v.to(self.device) for k, v in
                            rect_boundary_points(g_bnd, spec.extents,
                                                 opts.n_bc, horizon,
                                                 dtype=dt).items()}
            self.bnd_val_num = self._boundary_values(g_noise_b)
        self.ic_pts = None
        if spec.unsteady and opts.n_ic:
            self.ic_pts = (self._tensor(arrays["ic_pts"]) if arrays is not None
                           else initial_condition_points(
                               g_ic, spec.extents, opts.n_ic, dt
                           ).to(self.device))

        # fitting targets with noise (stage 6)
        iv, ip = (torch.as_tensor(self.idx_set[k], device=self.device)
                  for k in ("Vel", "Pres"))
        if arrays is not None:
            self.sol_noise = [self._tensor(a) for a in arrays["sol_noise"]]
        else:
            self.sol_noise = [
                self.sol_norm[c][idx] + generate_noise(
                    g_noise_f, len(idx), opts.noise_fit, dtype=dt
                ).to(self.device)
                for c, idx in ((0, iv), (1, iv), (2, ip))
            ]

        # stage 8: model, input extents folded into the layer-0 init
        in_extents = (([(0.0, spec.time_horizon)] if spec.unsteady else [])
                      + [tuple(e) for e in spec.extents])
        self.model = MLP(spec.dim_in, 3, width=spec.width, depth=spec.depth,
                         seed=self.seed, input_extents=in_extents,
                         dtype=dt, device=self.device)
        if arrays is not None:
            self.model.set_params([
                {k: torch.as_tensor(np.array(p[k]), dtype=dt)
                 for k in ("kernel", "bias")} for p in arrays["params"]])

        # stage 7: losses
        self.losses, self.losses_test = self._build_losses()

    def _boundary_values(self, generator: torch.Generator):
        """Dirichlet values live in normalized space (÷ norm_vel); Neumann
        right-hand sides stay physical (subtracted from the physical
        traction before the residual rescale)."""
        spec, nv = self.spec, self.norm.norm_vel
        out: Dict[int, Dict[str, torch.Tensor]] = {0: {}, 1: {}}
        for comp in (0, 1):
            for edge, value in (spec.bnd_val or {}).get(comp, {}).items():
                pts = self.bnd_pts[edge]
                scale = 1.0 if (edge, comp) in spec.neumann else 1.0 / nv
                if value is None:
                    base = torch.zeros(pts.shape[0], dtype=pts.dtype,
                                       device=self.device)
                elif callable(value):
                    base = torch.as_tensor(value(pts)) * scale
                else:
                    base = torch.full((pts.shape[0],), float(value) * scale,
                                      dtype=pts.dtype, device=self.device)
                out[comp][edge] = base + generate_noise(
                    generator, pts.shape[0], self.opts.noise_bnd,
                    dtype=self.dtype).to(self.device)
        return out

    def _build_losses(self):
        spec, opts = self.spec, self.opts
        model, norm = self.model, self.norm
        LMS = LossMeanSquares
        take = lambda idx: self.dom_grid[torch.as_tensor(idx, device=self.device)]

        def dir_pr(comp, x, rhs):
            r = torch.broadcast_to(torch.as_tensor(rhs, dtype=x.dtype,
                                                   device=x.device),
                                   (x.shape[0],))
            return (dirichlet_point_residual(model, comp), (x, r))

        losses = []
        x_pde = take(self.idx_set["PDE"])
        if opts.use_collloss:
            weights = (spec.weight("PDE_MASS", 1e1),
                       spec.weight("PDE_MOMU", 1e0),
                       spec.weight("PDE_MOMV", 1e0))
            # the LM round stacks every training loss's residual vector; the
            # fused objective exposes only the three MSEs, so an LM-bound
            # driver keeps the unfused PDE losses
            wants_residuals = self.second_round in LM_ROUNDS
            if not wants_residuals and use_fused_pde_losses(
                    model, spec.unsteady, spec.dim_in):
                # one-pass objective: loss + log MSEs + parameter gradients
                # from one kernel launch (its plain twin on the CPU)
                fused = FusedNSWeightedObjective(model, x_pde, spec.physics,
                                                 norm, weights=weights)
                f_mass, f_momu, f_momv = fused.loss_fns()
                losses += [
                    PrecomputedMeanSquares("PDE_MASS", f_mass, weight=weights[0]),
                    PrecomputedMeanSquares("PDE_MOMU", f_momu, weight=weights[1]),
                    PrecomputedMeanSquares("PDE_MOMV", f_momv, weight=weights[2]),
                ]
            else:
                # its own name: the closures read it when called, after the
                # boundary loop below has rebound ``bundle``
                pde_bundle = ResidualBundle(model, x_pde,
                                            unsteady=spec.unsteady)
                p_mass, p_momu, p_momv = pde_point_residuals(
                    model, spec.physics, norm, spec.unsteady)
                losses += [
                    LMS("PDE_MASS", lambda: mass_residual(pde_bundle, norm),
                        weight=weights[0], point_residual=(p_mass, (x_pde,))),
                    LMS("PDE_MOMU", lambda: momentum_residual(
                        pde_bundle, 0, spec.physics, norm), weight=weights[1],
                        point_residual=(p_momu, (x_pde,))),
                    LMS("PDE_MOMV", lambda: momentum_residual(
                        pde_bundle, 1, spec.physics, norm), weight=weights[2],
                        point_residual=(p_momv, (x_pde,))),
                ]

        if opts.use_boundary:
            edge_tags = {"SX": "x0", "DX": "x1", "BOT": "y0", "TOP": "y1"}
            comp_tags = {0: "u", 1: "v"}
            for comp in (0, 1):
                for edge, rhs in self.bnd_val_num[comp].items():
                    tag = f"{comp_tags[comp]}_{edge_tags[edge]}"
                    xb = self.bnd_pts[edge]
                    if (edge, comp) in spec.neumann:
                        direction = spec.neumann[(edge, comp)]
                        bundle = ResidualBundle(model, xb,
                                                unsteady=spec.unsteady)
                        rb = torch.broadcast_to(rhs, (xb.shape[0],))
                        losses.append(LMS(
                            f"BCN_{tag}",
                            (lambda b=bundle, c=comp, d=direction, r=rhs:
                             neumann_residual(b, c, d, spec.physics, norm,
                                              rhs=r)),
                            weight=spec.weight("BCN", 1e0),
                            point_residual=(neumann_point_residual(
                                model, comp, direction, spec.physics, norm,
                                spec.unsteady), (xb, rb))))
                    else:
                        losses.append(LMS(
                            f"BCD_{tag}",
                            (lambda x=xb, c=comp, r=rhs:
                             dirichlet_residual(model, x, c, r)),
                            weight=spec.weight("BCD", 1e0),
                            point_residual=dir_pr(comp, xb, rhs)))

        if spec.unsteady and opts.use_initialc and self.ic_pts is not None:
            xi = self.ic_pts
            for comp, name in enumerate(("IC_u", "IC_v", "IC_p")):
                losses.append(LMS(
                    name, (lambda c=comp:
                           initial_condition_residual(model, xi, c, 0.0)),
                    weight=spec.weight("IC", 1e0),
                    point_residual=dir_pr(comp, xi, 0.0)))

        x_vel = take(self.idx_set["Vel"])
        if opts.fit_velocity:
            fit_u, fit_v = self.sol_noise[0], self.sol_noise[1]
            losses += [
                LMS("Fit_u", lambda: dirichlet_residual(model, x_vel, 0, fit_u),
                    weight=spec.weight("FIT", 1e0),
                    point_residual=dir_pr(0, x_vel, fit_u)),
                LMS("Fit_v", lambda: dirichlet_residual(model, x_vel, 1, fit_v),
                    weight=spec.weight("FIT", 1e0),
                    point_residual=dir_pr(1, x_vel, fit_v)),
            ]

        x_pres = take(self.idx_set["Pres"])
        if spec.pressure_gauge == "fit" and opts.fit_pressure:
            fit_p = self.sol_noise[2]
            losses.append(LMS(
                "Fit_p", lambda: dirichlet_residual(model, x_pres, 2, fit_p),
                weight=spec.weight("FIT", 1e0),
                point_residual=dir_pr(2, x_pres, fit_p)))
        elif spec.pressure_gauge == "mean":
            # |mean p| over the pressure split, else over the PDE batch
            gauge_pts = x_pres if len(self.idx_set["Pres"]) else x_pde
            losses.append(Loss(
                "PRESS_0", lambda: pressure_mean_penalty(model, gauge_pts),
                weight=spec.weight("PRESS_0", 1e-2), non_negative=True))

        it = self.idx_set["Test"]
        x_test = take(it)
        it_t = torch.as_tensor(it, device=self.device)
        tst = [self.sol_norm[c][it_t] for c in range(3)]
        losses_test = [
            LMS(name, (lambda c=c: dirichlet_residual(model, x_test, c, tst[c])))
            for c, name in enumerate(("u_test", "v_test", "p_test"))
        ]
        return losses, losses_test

    # ------------------------------------------------------------------ train
    def train(self, epochs: Optional[int] = None, callbacks: bool = True,
              skip_training: bool = False,
              resume_from: Optional[str] = None) -> OptimizationProblem:
        """The Adam round (``adam_epochs`` full-batch steps at ``adam_lr``),
        then the second round for ``epochs`` iterations (default
        ``opts.epochs``), then History_Loss.json in the run folder.

        ``callbacks`` flush the history (and its plot, where matplotlib
        exists) and ``checkpoint.pkl`` into the run folder every 100
        iterations and at the end of every round.  ``resume_from`` names a
        saved run folder: its weights and history are loaded, then
        ``checkpoint.pkl`` where it is at least as new as the weights (its
        parameters, and its optimizer state for the second round of the
        same kind to adopt); the Adam round is skipped and the second round
        appends to the loaded history.  ``skip_training`` returns after
        loading."""
        epochs = self.opts.epochs if epochs is None else epochs
        if resume_from is not None:
            self.folder = resume_from
        else:
            self.folder = experiment.prepare_folder(self.base_dir,
                                                    self.save_results)
        pb = OptimizationProblem(self.model, self.losses, self.losses_test)
        if resume_from is not None:
            self._resume(pb, resume_from)
        if callbacks:
            pb.callbacks.append(HistoryPlotCallback(
                frequency=100, gui=False,
                filename=os.path.join(self.folder, "Loss_Trend_Full.png"),
                filename_history=os.path.join(self.folder,
                                              "History_Loss.json")))
            pb.callbacks.append(CheckpointCallback(
                os.path.join(self.folder, "checkpoint.pkl"), frequency=100))
        self.pb = pb
        if skip_training:
            return pb
        if resume_from is None:
            minimize(pb, "keras", Adam(learning_rate=self.adam_lr),
                     num_epochs=self.adam_epochs)
        run_second_round(pb, self.second_round, epochs,
                         scipy_method=self.scipy_method,
                         adam_lr=self.adam_lr)
        pb.save_history(os.path.join(self.folder, "History_Loss.json"))
        return pb

    def _resume(self, pb: OptimizationProblem, folder: str) -> None:
        resume_run(pb, folder)

    # ----------------------------------------------------------------- output
    def _grid_points(self, gx, gy) -> np.ndarray:
        """The points of a spatial grid; unsteady, at the final time
        slice."""
        cols = [gx.reshape(-1), gy.reshape(-1)]
        if self.spec.unsteady:
            t_final = self.spec.time_horizon - self.spec.dt
            cols = [np.full(gx.size, t_final)] + cols
        return np.stack(cols, axis=-1)

    def predict_grid(self, n: int = 100):
        """The model on an n×n regular grid of the spatial extents (unsteady:
        at the final time slice), de-normalized: (gx, gy, u, v, p) as numpy
        arrays."""
        (lx, ux), (ly, uy) = self.spec.extents
        gx, gy = np.meshgrid(np.linspace(lx, ux, n), np.linspace(ly, uy, n))
        pts = self._grid_points(gx, gy)
        with torch.no_grad():
            out = self.model(pts).cpu().numpy()
        u = out[:, 0].reshape(gx.shape) * self.norm.norm_vel
        v = out[:, 1].reshape(gx.shape) * self.norm.norm_vel
        p = out[:, 2].reshape(gx.shape) * self.norm.norm_pre
        return gx, gy, u, v, p

    def save_artifacts(self, loss_groups: Optional[Dict[str, list]] = None,
                       exact_grids=None) -> None:
        """Stages 10-13: the experiment (Model.json, weights, history,
        checkpoint), the contour figure (unsteady: at the final slice, and
        with ``exact_data`` the per-slice figures of ``save_time_slices``),
        the grouped loss plot and the recap.  The figures need
        matplotlib."""
        folder = self.folder
        if folder is None or self.pb is None:
            raise RuntimeError("save_artifacts: call train() first")
        self.save_experiment()
        gx, gy, u, v, p = self.predict_grid()
        if exact_grids is None and self.spec.exact is not None:
            pts = torch.as_tensor(self._grid_points(gx, gy), dtype=self.dtype)
            exact_grids = tuple(
                torch.as_tensor(f(pts)).cpu().numpy().reshape(gx.shape)
                for f in self.spec.exact)
        if exact_grids is not None:
            viz.contour_compare(gx, gy, exact_grids, (u, v, p),
                                problem_name=self.spec.name,
                                filename=os.path.join(folder, "Graphic.jpg"))
        if self.spec.unsteady and self.spec.exact_data is not None:
            self.save_time_slices(folder)
        if loss_groups:
            viz.plot_loss_groups(
                self.pb.history.to_dict(), loss_groups,
                filename=os.path.join(folder, "Loss_Trend_Reduced.png"))
        self.write_recap()

    def save_time_slices(self, folder: str, n_time_stamp: int = 4) -> list:
        """The unsteady case's exact-vs-PINN contour figures at
        ``n_time_stamp + 1`` times evenly spaced over [0, T] (t = T taken at
        the last stored slice), levels shared across the slices, the exact
        pressure recentred per slice: ``Graphic_{i}_of_{n}.jpg``."""
        spec = self.spec
        T, dt = spec.time_horizon, spec.dt
        n1, n2 = spec.grid_shape
        n_xy = (n1 + 1) * (n2 + 1)
        n_times = int(round(T / dt))
        times = np.linspace(0.0, T, n_time_stamp + 1)
        (lx, ux), (ly, uy) = spec.extents
        gx, gy = np.meshgrid(np.linspace(lx, ux, n1 + 1),
                             np.linspace(ly, uy, n2 + 1))
        flat = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
        norms = (self.norm.norm_vel, self.norm.norm_vel, self.norm.norm_pre)
        exact_slices, pinn_slices = [[], [], []], [[], [], []]
        for t in times:
            t_eff = T - dt if t >= T else t
            k = int(round(t_eff / dt))
            pts = np.concatenate([np.full((n_xy, 1), t_eff), flat], axis=1)
            with torch.no_grad():
                out = self.model(pts).cpu().numpy()
            for comp in range(3):
                ex = self.exact_fields[comp][k * n_xy:(k + 1) * n_xy]
                ex = ex.cpu().numpy().reshape(n2 + 1, n1 + 1)
                if comp == 2:
                    ex = ex - ex.mean()
                exact_slices[comp].append(ex)
                pinn_slices[comp].append(
                    out[:, comp].reshape(n2 + 1, n1 + 1) * norms[comp])
        return viz.contour_time_slices(gx, gy, exact_slices, pinn_slices,
                                       times, n_times, folder)

    def save_experiment(self) -> str:
        """Stage 10 alone: Model.json, the weights, History_Loss.json and
        checkpoint.pkl (with the last round's optimizer state) in the run
        folder; returns the weights file's name."""
        return ckpt.save_experiment(self.folder, self.model,
                                    self.pb.history,
                                    opt_state=self.pb.last_opt_state)

    def write_recap(self) -> str:
        """Stage 13 alone: Test_Options.txt in the run folder."""
        return experiment.write_recap(
            self.folder, self.spec.name, self.opts.epochs, self.opts.n_pts,
            noise_fit=self.opts.noise_fit, noise_bnd=self.opts.noise_bnd,
            echo=False)

    def final_test_losses(self) -> Dict[str, float]:
        h = self.pb.history
        return {name: entry["log"][-1] for name, entry in h.losses_test.items()}
