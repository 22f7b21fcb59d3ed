"""Navier–Stokes residual builders for the steady and unsteady 2-D cases.

General momentum residual:

    r_k = a_t ∂t U_k + a_c (U·∇)U_k − a_v ΔU_k + a_p ∂k P

with (a_t, a_c, a_v, a_p) = NSPhysics(time, conv, visc, pres); Poiseuille is
(0, ρ, μ, 1).  Fields are de-normalized inside the residual (U = norm_vel·u*,
P = norm_pre·p*) and the momentum residual is rescaled by
1/max(norm_pre, norm_vel), the reference's spread-normalization.

Two evaluators feed the PDE losses:

* :class:`FusedNSWeightedObjective` — the weighted PDE loss, its three raw
  MSEs and the parameter gradients from one call of
  :func:`tpinn_torch.kernels.mlp_bundle.ns_residual_weighted_obj` (the CUDA
  kernel on a CUDA batch, its plain twin on the CPU);
* :class:`ResidualBundle` + the ``*_residual`` row functions — residual
  vectors from the closed-form Taylor streams, for models the kernel does
  not take, and for the boundary (Neumann) losses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpinn_torch.geometry import Normalization
from tpinn_torch.kernels import mlp_bundle
from tpinn_torch.models import Model
from tpinn_torch.operators import mlp_taylor_batched


@dataclasses.dataclass(frozen=True)
class NSPhysics:
    """Momentum-equation coefficients (see module docstring)."""

    conv: float = 1.0  # a_c
    visc: float = 1.0  # a_v
    time: float = 0.0  # a_t (1 for unsteady)
    pres: float = 1.0  # a_p

    @property
    def unsteady(self) -> bool:
        return self.time != 0.0


def _params_key(params) -> tuple:
    """Identity of a parameter state: the optimizer updates tensors in
    place, so object identity never changes but every in-place update bumps
    the tensor's version counter.  Grad mode is part of the key, so a value
    computed under no_grad is never handed to a training step."""
    flat = [t for p in params for t in (p["kernel"], p["bias"])]
    return (tuple((id(t), t._version) for t in flat),
            torch.is_grad_enabled())


class ResidualBundle:
    """Per-batch (value, jacobian, hessian-diag) of the (u, v, p) field,
    by closed-form Taylor propagation (plain tanh MLPs only).

    ``spatial_cols`` maps spatial axis -> input column: (0, 1) steady,
    (1, 2) unsteady where column 0 is time."""

    def __init__(self, model: Model, x: torch.Tensor, unsteady: bool = False):
        if not model.is_plain_tanh():
            raise NotImplementedError(
                "ResidualBundle is ported for plain tanh MLPs only (the "
                "jet path for other models is not ported)")
        self.model = model
        self.x = x
        self.unsteady = unsteady
        self.dim_in = int(x.shape[-1])
        self.spatial_cols = (1, 2) if unsteady else (0, 1)
        self._memo = None

    def compute(self):
        params = self.model.params
        key = _params_key(params)
        if self._memo is None or self._memo[0] != key:
            self._memo = (key, mlp_taylor_batched(params, self.x, self.dim_in))
        return self._memo[1]


def _mass_rows(jac, cols):
    cx, cy = cols
    return jac[:, 0, cx] + jac[:, 1, cy]


def _momentum_rows(value, jac, hdiag, cols, k, physics, norm):
    cx, cy = cols
    nv, npre = norm.norm_vel, norm.norm_pre
    U = nv * value[:, 0]
    V = nv * value[:, 1]
    dUk_dx = nv * jac[:, k, cx]
    dUk_dy = nv * jac[:, k, cy]
    lap_Uk = nv * (hdiag[:, k, cx] + hdiag[:, k, cy])
    dP_dk = npre * jac[:, 2, (cx, cy)[k]]
    r = (physics.conv * (U * dUk_dx + V * dUk_dy)
         - physics.visc * lap_Uk
         + physics.pres * dP_dk)
    if physics.unsteady:
        r = r + physics.time * nv * jac[:, k, 0]
    return r * norm.residual_scale


def _neumann_rows(value, jac, cols, k, direction, physics, norm, rhs):
    cx, cy = cols
    nv, npre = norm.norm_vel, norm.norm_pre
    P = npre * value[:, 2]
    gx = nv * jac[:, k, cx]
    gy = nv * jac[:, k, cy]
    if isinstance(direction, int):
        grad_n = (gx, gy)[direction]
        p_term = P * (1.0 if direction == k else 0.0)
    else:
        n0, n1 = (float(v) for v in direction)
        grad_n = gx * n0 + gy * n1
        p_term = P * (n0, n1)[k]
    return (physics.visc * grad_n - p_term - rhs) * norm.residual_scale


def mass_residual(bundle: ResidualBundle, norm: Normalization):
    """∇·U (scaled by norm_vel uniformly, so left in normalized units)."""
    _, jac, _ = bundle.compute()
    return _mass_rows(jac, bundle.spatial_cols)


def momentum_residual(bundle: ResidualBundle, k: int, physics: NSPhysics,
                      norm: Normalization):
    """r_k as in the module docstring, spread-rescaled."""
    value, jac, hdiag = bundle.compute()
    return _momentum_rows(value, jac, hdiag, bundle.spatial_cols, k,
                          physics, norm)


def neumann_residual(bundle: ResidualBundle, k: int, direction,
                     physics: NSPhysics, norm: Normalization, rhs=0.0):
    """Traction residual μ ∂U_k/∂x_j − P δ_kj − rhs for an axis normal j, or
    ν (∇U_k·n) − P n_k − rhs for a (possibly oblique) normal vector n."""
    value, jac, _ = bundle.compute()
    return _neumann_rows(value, jac, bundle.spatial_cols, k, direction,
                         physics, norm, rhs)


def dirichlet_residual(model: Model, points: torch.Tensor, component: int,
                       rhs):
    """u_k(points) − rhs in normalized space (BC / fit / test losses)."""
    return model(points)[:, component] - rhs


class FusedNSResidualMSEs:
    """The three PDE MSEs (mass, mom-u, mom-v) from one call of
    ``ns_residual_mse`` (kernel 2 forward, kernel 1 backward on CUDA),
    shared by the three per-loss closures through a version-keyed memo."""

    def __init__(self, model: Model, x: torch.Tensor, physics: NSPhysics,
                 norm: Normalization, n_true: Optional[int] = None):
        self.model = model
        self.x = x
        self.physics = physics
        self.norm = norm
        self.n_true = int(x.shape[0]) if n_true is None else int(n_true)
        self._memo = None

    def mses(self):
        params = self.model.params
        key = _params_key(params)
        if self._memo is None or self._memo[0] != key:
            m = mlp_bundle.ns_residual_mse(
                params, self.x, self.physics, self.norm,
                n_valid=self.n_true, n_mean=self.n_true)
            self._memo = (key, m)
        return self._memo[1]

    def loss_fns(self):
        return (lambda: self.mses()[0], lambda: self.mses()[1],
                lambda: self.mses()[2])


class FusedNSWeightedObjective:
    """One-pass training objective: weighted PDE loss + raw MSE log channels
    + parameter gradients from a single kernel launch.

    ``loss_fns()`` returns three closures shaped like per-loss MSEs: each
    logged value is the exact raw MSE, and the first channel whose weight is
    nonzero carries the gradient surrogate ``(L − L.detach())/w``, which is
    exactly 0.0 in value, so the gradient of ``Σ wᵢ·fᵢ()`` is exactly ∇L.

    The three closures share one call per parameter state through a memo
    keyed on the parameters' version counters (the optimizer updates them in
    place, so object identity would hand back the previous step's loss).
    Under ``torch.no_grad`` (the logged evaluations) no gradient is needed,
    so the MSEs come from the forward kernel alone."""

    def __init__(self, model: Model, x: torch.Tensor, physics: NSPhysics,
                 norm: Normalization, weights, n_true: Optional[int] = None):
        self.model = model
        self.x = x
        self.physics = physics
        self.norm = norm
        self.weights = tuple(float(w) for w in weights)
        self._weights_t = torch.tensor(self.weights, dtype=x.dtype,
                                       device=x.device)
        self.n_true = int(x.shape[0]) if n_true is None else int(n_true)
        self._memo = None

    def _compute(self):
        params = self.model.params
        key = _params_key(params)
        if self._memo is not None and self._memo[0] == key:
            return self._memo[1]
        if torch.is_grad_enabled():
            out = mlp_bundle.ns_residual_weighted_obj(
                params, self.x, self.physics, self.norm, self._weights_t,
                n_valid=self.n_true, n_mean=self.n_true)
        else:
            out = (None, mlp_bundle.ns_residual_mse(
                params, self.x, self.physics, self.norm,
                n_valid=self.n_true, n_mean=self.n_true))
        self._memo = (key, out)
        return out

    def loss_fns(self):
        # the gradient rides the first channel whose weight is nonzero
        gi = next((i for i, w in enumerate(self.weights) if w != 0.0), 0)
        wg = self.weights[gi] or 1.0

        def chan(i):
            def fn():
                L, m = self._compute()
                v = m[i].detach()
                if i == gi and L is not None:
                    v = v + (L - L.detach()) / wg
                return v
            return fn

        return chan(0), chan(1), chan(2)


def use_fused_pde_losses(model: Model, spec_unsteady: bool,
                         dim_in: int) -> bool:
    """Route the PDE losses through the fused objective: a plain tanh MLP
    whose widths the CUDA kernel takes, steady (x, y) or unsteady (t, x, y).
    The batch's device then picks the kernel (CUDA) or its plain twin (CPU)."""
    eligible = dim_in == (3 if spec_unsteady else 2) and model.is_plain_tanh()
    return eligible and mlp_bundle.fits_kernel(model.layer_sizes, dim_in,
                                               model.dtype)
