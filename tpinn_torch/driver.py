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
  9  training: the Adam round      → tpinn_torch.optimize.minimize

This port covers the steady case on one device with the Adam round only
(``second_round="none"``).  The PDE losses of a plain tanh MLP go through
the one-pass fused objective: on a CUDA device one launch of the residual
kernel per Adam step.  ``from_arrays`` builds the driver from given grid,
splits, boundary data, fit targets and initial parameters, so a run can
start from exactly the data of another implementation.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpinn_torch import config, experiment
from tpinn_torch.config import SimulationOptions
from tpinn_torch.geometry import (
    Normalization,
    generate_noise,
    rect_boundary_points,
    rect_grid,
    split_indices,
)
from tpinn_torch.losses import LossMeanSquares, PrecomputedMeanSquares
from tpinn_torch.models import MLP
from tpinn_torch.optimize import minimize
from tpinn_torch.optimizers import Adam
from tpinn_torch.pipeline import (
    FusedNSWeightedObjective,
    NSPhysics,
    ResidualBundle,
    dirichlet_residual,
    mass_residual,
    momentum_residual,
    neumann_residual,
    use_fused_pde_losses,
)
from tpinn_torch.problem import OptimizationProblem

BndValue = Union[float, Callable, None]


@dataclasses.dataclass
class CaseSpec:
    """Declarative description of a rectangular Navier–Stokes PINN case."""

    name: str
    extents: Sequence[Tuple[float, float]]
    physics: NSPhysics = NSPhysics()
    grid_shape: Tuple[int, int] = (100, 100)
    # exact solution: callables (u, v, p)(points) -> (N,)
    exact: Optional[Tuple[Callable, Callable, Callable]] = None
    # Dirichlet boundary values per component {0: {edge: value}, 1: {...}}
    # value: float | callable(points)->(N,) | None
    bnd_val: Optional[Dict[int, Dict[str, BndValue]]] = None
    # Neumann specs {(edge, component): direction}; rhs comes from bnd_val
    neumann: Dict[Tuple[str, int], object] = dataclasses.field(default_factory=dict)
    weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    unsteady: bool = False  # the unsteady path is not ported: raises
    width: int = 32
    depth: int = 3

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
        second_round: str = "none",
        adam_epochs: int = 100,
        adam_lr: float = 1e-2,
        device=None,
        dtype: Optional[torch.dtype] = None,
        arrays: Optional[dict] = None,
    ):
        if spec.unsteady:
            raise NotImplementedError(
                "the unsteady driver path is not ported yet (ROADMAP.md, "
                "port queue 1)")
        if second_round not in ("none", None):
            raise NotImplementedError(
                f"second_round={second_round!r}: only the Adam round is "
                "ported (BFGS / L-BFGS / LM rounds: ROADMAP.md, port queue 1)")
        self.spec = spec
        self.opts = opts
        self.base_dir = base_dir
        self.save_results = save_results
        self.seed = seed
        self.second_round = second_round
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
                    **kw) -> "StandardNSDriver":
        """A driver on given data instead of its own random draws: the grid
        (N, d), the index splits {PDE, Vel, Pres, Test}, the boundary points
        per edge, the boundary values per component and edge, the noisy fit
        targets [u, v, p] and the initial params (list of {kernel, bias})."""
        arrays = dict(dom_grid=dom_grid, idx_set=idx_set, bnd_pts=bnd_pts,
                      bnd_val_num=bnd_val_num, sol_noise=sol_noise,
                      params=params)
        return cls(spec, opts, arrays=arrays, **kw)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------ build
    def _build(self, arrays: Optional[dict]) -> None:
        spec, opts, dt = self.spec, self.opts, self.dtype
        gens = [torch.Generator().manual_seed(int(s)) for s in
                np.random.SeedSequence(self.seed).generate_state(4)]
        g_split, g_bnd, g_noise_b, g_noise_f = gens

        # stage 3: grid and splits
        if arrays is not None:
            dom_grid = torch.as_tensor(np.array(arrays["dom_grid"]), dtype=dt)
            self.idx_set = {k: np.array(v) for k, v in arrays["idx_set"].items()}
        else:
            dom_grid = rect_grid(spec.extents, spec.grid_shape, dt)
            self.idx_set = split_indices(g_split, dom_grid.shape[0], opts.n_pts)
        self.dom_grid = dom_grid.to(self.device)

        # stage 4: exact solution on the grid
        if spec.exact is None:
            raise ValueError("CaseSpec needs the exact-solution callables")
        u_ex, v_ex, p_ex = (torch.as_tensor(f(self.dom_grid), dtype=dt,
                                            device=self.device)
                            for f in spec.exact)
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
            self.bnd_pts = {k: v.to(self.device) for k, v in
                            rect_boundary_points(g_bnd, spec.extents,
                                                 opts.n_bc, dtype=dt).items()}
            self.bnd_val_num = self._boundary_values(g_noise_b)

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
        self.model = MLP(spec.dim_in, 3, width=spec.width, depth=spec.depth,
                         seed=self.seed, input_extents=list(spec.extents),
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

        losses = []
        if opts.use_collloss:
            x_pde = take(self.idx_set["PDE"])
            weights = (spec.weight("PDE_MASS", 1e1),
                       spec.weight("PDE_MOMU", 1e0),
                       spec.weight("PDE_MOMV", 1e0))
            if use_fused_pde_losses(model, spec.unsteady, spec.dim_in):
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
                bundle = ResidualBundle(model, x_pde, unsteady=spec.unsteady)
                losses += [
                    LMS("PDE_MASS", lambda: mass_residual(bundle, norm),
                        weight=weights[0]),
                    LMS("PDE_MOMU", lambda: momentum_residual(
                        bundle, 0, spec.physics, norm), weight=weights[1]),
                    LMS("PDE_MOMV", lambda: momentum_residual(
                        bundle, 1, spec.physics, norm), weight=weights[2]),
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
                        losses.append(LMS(
                            f"BCN_{tag}",
                            (lambda b=bundle, c=comp, d=direction, r=rhs:
                             neumann_residual(b, c, d, spec.physics, norm,
                                              rhs=r)),
                            weight=spec.weight("BCN", 1e0)))
                    else:
                        losses.append(LMS(
                            f"BCD_{tag}",
                            (lambda x=xb, c=comp, r=rhs:
                             dirichlet_residual(model, x, c, r)),
                            weight=spec.weight("BCD", 1e0)))

        x_vel = take(self.idx_set["Vel"])
        if opts.fit_velocity:
            fit_u, fit_v = self.sol_noise[0], self.sol_noise[1]
            losses += [
                LMS("Fit_u", lambda: dirichlet_residual(model, x_vel, 0, fit_u),
                    weight=spec.weight("FIT", 1e0)),
                LMS("Fit_v", lambda: dirichlet_residual(model, x_vel, 1, fit_v),
                    weight=spec.weight("FIT", 1e0)),
            ]

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
    def train(self) -> OptimizationProblem:
        """The Adam round (``adam_epochs`` full-batch steps at ``adam_lr``),
        then History_Loss.json in the run folder."""
        self.folder = experiment.prepare_folder(self.base_dir,
                                                self.save_results)
        pb = OptimizationProblem(self.model, self.losses, self.losses_test)
        self.pb = pb
        minimize(pb, "keras", Adam(learning_rate=self.adam_lr),
                 num_epochs=self.adam_epochs)
        pb.save_history(os.path.join(self.folder, "History_Loss.json"))
        return pb

    def final_test_losses(self) -> Dict[str, float]:
        h = self.pb.history
        return {name: entry["log"][-1] for name, entry in h.losses_test.items()}
