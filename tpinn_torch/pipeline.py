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
  :class:`FusedPoissonObjective` is its Poisson member (−Δu = f);
* :class:`ResidualBundle` + the ``*_residual`` row functions — residual
  vectors from the closed-form Taylor streams (or, under the
  ``TPINN_USE_PALLAS`` opt-in, from kernel 5), for models the fused kernels
  do not take, for the boundary (Neumann) losses, and for the unfused PDE
  losses the Levenberg–Marquardt round needs;
* the ``*_point_residual`` builders — the same rows at one point with
  explicit params, for the LM round's per-point Gram.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
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


_OFF_VALUES = ("0", "false", "False")


def use_pallas_default() -> bool:
    """The ``TPINN_USE_PALLAS`` opt-in, read as the JAX package reads it:
    unset means off; "0", "false" and "False" mean off; any other value on.
    One variable drives both packages."""
    env = os.environ.get("TPINN_USE_PALLAS")
    return env is not None and env not in _OFF_VALUES


class ResidualBundle:
    """Per-batch (value, jacobian, hessian-diag) of the (u, v, p) field of
    a plain tanh MLP.

    By default the closed-form Taylor propagation computes it
    (``mlp_taylor_batched``).  With ``use_pallas`` on (the argument, else
    the ``TPINN_USE_PALLAS`` variable; off by default) it comes from
    :func:`tpinn_torch.kernels.mlp_bundle.mlp_taylor_bundle`: kernel 5 on a
    CUDA batch, its plain version on the CPU, forward only in both, as in
    the JAX package.  The residual closures of one bundle share one
    computation per parameter state (version-keyed memo).

    ``spatial_cols`` maps spatial axis -> input column: (0, 1) steady,
    (1, 2) unsteady where column 0 is time."""

    def __init__(self, model: Model, x: torch.Tensor, unsteady: bool = False,
                 use_pallas: Optional[bool] = None):
        if not model.is_plain_tanh():
            raise NotImplementedError(
                "ResidualBundle is ported for plain tanh MLPs only (the "
                "jet path for other models is not ported)")
        self.model = model
        self.x = x
        self.unsteady = unsteady
        self.dim_in = int(x.shape[-1])
        self.spatial_cols = (1, 2) if unsteady else (0, 1)
        self.use_pallas = (use_pallas_default() if use_pallas is None
                           else bool(use_pallas))
        self._memo = None

    def compute(self):
        params = self.model.params
        key = _params_key(params)
        if self._memo is None or self._memo[0] != key:
            if self.use_pallas:
                out = mlp_bundle.mlp_taylor_bundle(params, self.x,
                                                   dim=self.dim_in)
            else:
                out = mlp_taylor_batched(params, self.x, self.dim_in)
            self._memo = (key, out)
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


def pressure_mean_penalty(model: Model, points: torch.Tensor):
    """|mean p| over ``points``: the pressure-gauge penalty (PRESS_0, a
    ``Loss`` with ``non_negative=True``)."""
    return torch.abs(torch.mean(model(points)[:, 2]))


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


class FusedPoissonObjective:
    """One-pass Poisson objective: the weighted −Δu − f loss, its raw MSE
    log channel and the parameter gradients from one call of
    :func:`tpinn_torch.kernels.mlp_bundle.poisson_residual_weighted_obj`
    (kernel 3 on a CUDA batch, its plain twin on the CPU); under
    ``torch.no_grad`` the MSE alone, from the forward (kernel 4).  Same memo
    contract as :class:`FusedNSWeightedObjective`."""

    def __init__(self, model: Model, x: torch.Tensor, f: torch.Tensor,
                 weight: float, normalization: float = 1.0):
        self.model = model
        self.x = x
        self.f = f.reshape(-1)
        self.weight = float(weight)
        self.normalization = float(normalization)
        self._weight_t = torch.tensor([self.weight], dtype=x.dtype,
                                      device=x.device)
        self._memo = None

    def _compute(self):
        params = self.model.params
        key = _params_key(params)
        if self._memo is not None and self._memo[0] == key:
            return self._memo[1]
        if torch.is_grad_enabled():
            out = mlp_bundle.poisson_residual_weighted_obj(
                params, self.x, self.f, self._weight_t,
                normalization=self.normalization)
        else:
            out = (None, mlp_bundle.poisson_residual_mse(
                params, self.x, self.f, normalization=self.normalization))
        self._memo = (key, out)
        return out

    def loss_fn(self):
        """Closure for PrecomputedMeanSquares: logs the exact raw MSE while
        carrying the one-pass gradient through the surrogate term
        ``(L − L.detach())/w``, which is exactly 0.0 in value."""
        w = self.weight or 1.0

        def fn():
            L, mse = self._compute()
            v = mse.detach()
            if L is not None:
                v = v + (L - L.detach()) / w
            return v

        return fn


def use_fused_pde_losses(model: Model, spec_unsteady: bool,
                         dim_in: int) -> bool:
    """Route the PDE losses through a fused objective: a plain tanh MLP,
    steady (x, y) or unsteady (t, x, y), whose widths the CUDA kernels take:
    the NS kernels for a (u, v, p) head, the Poisson kernels for a scalar
    head on (x, y).  The batch's device then picks the kernel (CUDA) or its
    plain twin (CPU).  An eligible net that no kernel takes warns, naming
    its widths, and takes the plain PyTorch path.  ``TPINN_USE_PALLAS``
    set to "0", "false" or "False" switches the fused objectives off, as
    in the JAX package."""
    if os.environ.get("TPINN_USE_PALLAS") in _OFF_VALUES:
        return False
    eligible = dim_in == (3 if spec_unsteady else 2) and model.is_plain_tanh()
    if not eligible:
        return False
    widths = model.layer_sizes
    if widths[-1] == 1 and not spec_unsteady:
        fits = mlp_bundle.fits_poisson_kernel(widths, model.dtype)
    else:
        fits = mlp_bundle.fits_kernel(widths, dim_in, model.dtype)
    if not fits:
        warnings.warn(
            f"fused PDE-loss kernels disabled: the CUDA residual kernels do "
            f"not take widths {list(widths)} (a (u, v, p) or, on (x, y), a "
            f"scalar head; at most {mlp_bundle.MAX_LAYERS} layers of at most "
            f"{mlp_bundle.MAX_WIDTH}; one point's working set within "
            f"{mlp_bundle.SMEM_LIMIT} bytes of shared memory); taking the "
            "plain PyTorch path",
            stacklevel=2,
        )
    return fits


# ---------------------------------------------------------------------------
# Per-point residual builders (LossMeanSquares.point_residual protocol)
# ---------------------------------------------------------------------------
#
# Every residual component depends on exactly one point, so the LM round's
# Jacobian is built row by row as a vmap over points of a one-point
# gradient.  Each builder returns fn(params, *row_args) -> scalar with
# explicit params, on plain tensor ops that torch.func can map and
# differentiate; the row formulas are the batch closures' (on a 1-row
# batch).


def taylor_tri_fn(model: Model, dim_in: int):
    """(params, x) -> (value, jac, hdiag) with explicit params (any batch),
    by the closed-form propagation (plain tanh MLPs)."""
    if not model.is_plain_tanh():
        raise NotImplementedError(
            "point residuals are ported for plain tanh MLPs only")
    return lambda params, x: mlp_taylor_batched(params, x, dim_in)


def pde_point_residuals(model: Model, physics: NSPhysics,
                        norm: Normalization, unsteady: bool = False):
    """(mass_fn, momu_fn, momv_fn), each fn(params, xi) -> scalar."""
    cols = (1, 2) if unsteady else (0, 1)
    tri = taylor_tri_fn(model, 3 if unsteady else 2)

    def mass_fn(params, xi):
        _, jac, _ = tri(params, xi[None, :])
        return _mass_rows(jac, cols)[0]

    def mom_fn(k):
        def fn(params, xi):
            value, jac, hdiag = tri(params, xi[None, :])
            return _momentum_rows(value, jac, hdiag, cols, k, physics,
                                  norm)[0]
        return fn

    return mass_fn, mom_fn(0), mom_fn(1)


def neumann_point_residual(model: Model, k: int, direction,
                           physics: NSPhysics, norm: Normalization,
                           unsteady: bool = False):
    """fn(params, xi, rhs_i) -> scalar traction residual at one point."""
    cols = (1, 2) if unsteady else (0, 1)
    tri = taylor_tri_fn(model, 3 if unsteady else 2)

    def fn(params, xi, rhs_i):
        value, jac, _ = tri(params, xi[None, :])
        return _neumann_rows(value, jac, cols, k, direction, physics, norm,
                             rhs_i)[0]

    return fn


def dirichlet_point_residual(model: Model, component: int):
    """fn(params, xi, rhs_i) -> scalar u_k(xi) − rhs_i (BC / fit)."""

    def fn(params, xi, rhs_i):
        return model.apply(params, xi[None, :])[0, component] - rhs_i

    return fn


def scaled_point_residual(fn):
    """Wrap a point-residual fn(params, *rows) to take a trailing
    mask-scale row (the sharded batches' exactness protocol: a zero-scaled
    padding row has zero residual and zero gradient)."""

    def wrapped(params, *rows):
        return fn(params, *rows[:-1]) * rows[-1]

    return wrapped
