"""Optimization driver: ``minimize(pb, strategy, optimizer, num_epochs)``.

* ``minimize(pb, "keras", opt, num_epochs)`` runs a full-batch first-order
  round, ``opt`` being ``optimizers.Adam``, ``SGD`` or ``AdamW`` (or a
  number: Adam's learning rate), logged as ``keras_<name>`` at iterations
  0, 10, 20, ... and the final one.  Each step evaluates the global loss
  once and differentiates it with ``torch.autograd.grad``; on a fused PDE
  path that is one launch of the one-pass residual kernel per step.
* ``minimize(pb, "scipy", "L-BFGS-B" | "BFGS", num_epochs)`` runs a host
  quasi-Newton round through ``scipy.optimize.minimize`` with the value
  and gradient computed on the model's device (one host-to-device and one
  device-to-host copy per function evaluation), logged as
  ``scipy_<method>`` at iteration 0, every multiple of the log stride and
  the last iteration.
* ``minimize(pb, "jax", "BFGS", num_epochs)`` runs dense BFGS on the
  device (round ``jax_BFGS``): the inverse Hessian, the direction, a
  strong-Wolfe line search and the rank-2 update stay on the model's
  device; the host reads one flag per line-search trial.
* ``minimize(pb, "jax", "L-BFGS", num_epochs)`` (also
  ``minimize(pb, "lbfgs", ...)``) runs optax's L-BFGS on the device (round
  ``jax_L-BFGS``): memory 50, the two-loop direction over the ring of
  curvature pairs, and optax's zoom line search
  (``tpinn_torch.linesearch``); the host reads one flag tensor per
  line-search trial.
* ``minimize(pb, "jax", "LM", num_epochs)`` runs Levenberg–Marquardt on the
  stacked residual vector (round ``jax_LM``): the normal equations from the
  per-point Gram on the device, one host eigendecomposition per iteration,
  and damped steps accepted by a paired-difference test.

Second-order rounds run with IEEE float32 products (no TF32).
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch

from tpinn_torch.history import LOG_STRIDE
from tpinn_torch.linesearch import ScaleByZoomLinesearch
from tpinn_torch.losses import LossMeanSquares
from tpinn_torch.optimizers import Adam, Optimizer
from tpinn_torch.problem import OptimizationProblem


def _log_point(pb: OptimizationProblem, iter_in_round: int,
               theta=None) -> None:
    """Publish the logged parameters (a flat device tensor or a host
    vector, when given) into the model, append the evaluation to the
    history, then fire the callbacks at the global iteration, so that a
    checkpoint taken there holds the state the history claims."""
    if isinstance(theta, torch.Tensor):
        pb.set_flat(theta)
    elif theta is not None:
        pb.set_vector(theta)
    total, train, test = pb.eval_all()
    pb.history.append(iter_in_round, total, train, test)
    pb.fire_callbacks(pb.history.round_starts[-1] + iter_in_round)


def _consume_resume_state(pb: OptimizationProblem, kind: str):
    """The checkpointed optimizer state on ``pb.resume_opt_state`` when it
    is of ``kind``, taken once; a state of another kind stays for the round
    it belongs to."""
    st = getattr(pb, "resume_opt_state", None)
    if isinstance(st, dict) and str(st.get("kind")) == kind:
        pb.resume_opt_state = None
        return st
    return None


def _log_iters(num_epochs: int, stride: int):
    """Iterations (within a round) at which the reference logs: 0, s, 2s,
    ... plus the final iteration when not already a multiple of s."""
    iters = list(range(0, num_epochs + 1, stride))
    if iters[-1] != num_epochs:
        iters.append(num_epochs)
    return iters


def _first_order_optimizer(optimizer) -> Optimizer:
    """The optimizer a first-order round runs: one of the port's, or Adam
    at a given learning rate (Adam(1e-2) for None), as the JAX package
    accepts them."""
    if optimizer is None:
        return Adam()
    if isinstance(optimizer, Optimizer):
        return optimizer
    if isinstance(optimizer, (int, float)) and not isinstance(optimizer, bool):
        return Adam(float(optimizer))
    raise TypeError(
        f"unsupported optimizer {optimizer!r}: pass tpinn_torch.optimizers."
        "Adam, SGD or AdamW, or a learning rate (optax transforms belong to "
        "the JAX package and do not run here)")


def _minimize_first_order(pb: OptimizationProblem, optimizer: Optimizer,
                          num_epochs: int, round_name: str):
    params = pb.params
    optimizer.init(params)

    pb.history.start_round(round_name)
    pb.last_round_name = round_name
    # no round resumes a first-order state, so checkpoints carry none
    pb.last_opt_state = None
    t0 = time.perf_counter()
    _log_point(pb, 0)
    done = 0
    for target in _log_iters(num_epochs, LOG_STRIDE)[1:]:
        for _ in range(target - done):
            loss = pb.loss_fn()
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
            optimizer.step(params, grads)
        done = target
        _log_point(pb, done)
    pb.history.add_wall_time(time.perf_counter() - t0)
    pb.fire_callbacks(pb.history.iters[-1], force=True)
    return params


def _minimize_scipy(pb: OptimizationProblem, method: str, num_epochs: int):
    from scipy import optimize as sciopt

    round_name = f"scipy_{method}"
    pb.history.start_round(round_name)
    pb.last_round_name = round_name
    pb.last_opt_state = None  # scipy keeps its quasi-Newton state
    t0 = time.perf_counter()
    x0 = pb.get_vector()
    _log_point(pb, 0)
    it = {"n": 0}

    def callback(xk):
        it["n"] += 1
        if it["n"] % LOG_STRIDE == 0:
            _log_point(pb, it["n"], xk)

    res = sciopt.minimize(pb.value_and_grad_vector, x0, jac=True,
                          method=method, callback=callback,
                          options={"maxiter": num_epochs})
    pb.set_vector(res.x)
    if it["n"] % LOG_STRIDE != 0:
        _log_point(pb, it["n"])
    pb.history.add_wall_time(time.perf_counter() - t0)
    pb.fire_callbacks(pb.history.iters[-1], force=True)
    return pb.params


# ---------------------------------------------------------------------------
# Dense BFGS on the device (round jax_BFGS)
# ---------------------------------------------------------------------------

# ROADMAP.md port queue 1 item of the float32 split-parameter carries (the
# BFGS variant and the LM round's)
_SPLIT_ITEM = 14


def _wolfe_zoom_linesearch(f_1d, f0, g0, max_iters=30, c1=1e-4, c2=0.9):
    """Strong-Wolfe line search on φ(a) = f(x + a·d), also accepting the
    Hager–Zhang approximate-Wolfe conditions

        φ(a) ≤ φ(0) + ε|φ(0)|   and   (2c1−1)φ'(0) ≥ φ'(a) ≥ c2 φ'(0)

    (δ = 0.1, ε = 10·eps of the dtype), which certify a decrease through φ'
    where float32 cannot resolve it in φ.  ``f_1d(a) -> (φ(a), φ'(a))`` with
    ``a`` a 0-d tensor of ``f0``'s dtype.  Bracketing, then bisection: the
    trial doubles while no bracket exists.  The state (bracket, trial, best
    point) stays in 0-d device tensors; the host reads one flag per trial.
    Without an accepted trial the best finite one is taken (a NaN trial
    never becomes the best).  Returns (alpha, φ(alpha)), φ evaluated anew at
    the returned alpha."""
    eps_rel = 10.0 * torch.finfo(f0.dtype).eps
    delta = 0.1
    lo = torch.zeros_like(f0)
    hi = torch.full_like(f0, math.inf)
    alpha = torch.ones_like(f0)
    best_a = torch.zeros_like(f0)
    best_f = f0
    done, it = False, 0
    while it < max_iters and not done:
        fa, ga = f_1d(alpha)
        armijo = fa <= f0 + c1 * alpha * g0
        curv = torch.abs(ga) <= c2 * torch.abs(g0)
        approx = ((fa <= f0 + eps_rel * torch.abs(f0))
                  & (ga >= c2 * g0) & (ga <= (2.0 * delta - 1.0) * g0))
        ok = (armijo & curv) | approx
        # an overshoot (Armijo fails) or a positive slope with Armijo caps
        # the bracket at alpha
        hi = torch.where(~armijo, alpha, hi)
        hi = torch.where(armijo & (ga >= 0), alpha, hi)
        lo = torch.where(armijo & (ga < 0), alpha, lo)
        new_alpha = torch.where(torch.isinf(hi), alpha * 2.0, 0.5 * (lo + hi))
        better = torch.isfinite(fa) & (fa < best_f)
        best_a = torch.where(better, alpha, best_a)
        best_f = torch.where(better, fa, best_f)
        alpha = torch.where(ok, alpha, new_alpha)
        done = bool(ok)
        it += 1
    if not done:
        alpha = best_a
    fa, _ = f_1d(alpha)
    return alpha, fa


def _bfgs_update_H(H, s, y, first, failed):
    """Rank-2 update of the inverse Hessian H with the step s and the
    gradient change y, without a host branch:

    * the curvature pair is taken only when yᵀs > 0.1·sqrt(eps)·|y|·|s|
      (dtype-scaled: a noise-dominated pair would corrupt H);
    * the first taken pair scales H by yᵀs/yᵀy (Nocedal & Wright 6.20);
    * the O(n²) form of V H Vᵀ + ρssᵀ (V = I − ρsyᵀ, H symmetric):
      H − ρ(s(Hy)ᵀ + (Hy)sᵀ) + (ρ²·yᵀHy + ρ)·ssᵀ;
    * after a failed line search H restarts at I, and the next taken pair
      scales it again.

    Returns (H, first)."""
    eps = torch.finfo(H.dtype).eps
    ys = torch.dot(y, s)
    safe = (ys > 0.1 * math.sqrt(eps) * torch.linalg.norm(y)
            * torch.linalg.norm(s))
    rho = torch.where(safe, 1.0 / torch.where(safe, ys, 1.0), 0.0)
    gamma = torch.where(first & safe, ys / torch.dot(y, y), 1.0)
    H_eff = H * gamma
    Hy = H_eff @ y
    yHy = torch.dot(y, Hy)
    H_upd = (H_eff
             - rho * (torch.outer(s, Hy) + torch.outer(Hy, s))
             + (rho * rho * yHy + rho) * torch.outer(s, s))
    H_new = torch.where(safe, H_upd, H_eff)
    H_new = torch.where(failed, torch.eye(H.shape[0], dtype=H.dtype,
                                          device=H.device), H_new)
    return H_new, (first & ~safe) | failed


def _all_finite(*ts) -> torch.Tensor:
    out = torch.isfinite(ts[0]).all()
    for t in ts[1:]:
        out = out & torch.isfinite(t).all()
    return out


def _adopt_carry(st, x0: torch.Tensor, n_leaves: int):
    """A checkpointed carry as device tensors, when its parameter channel
    has x0's shape and dtype and equals x0 bit for bit (so any change of
    the parameters since the checkpoint discards it); else None."""
    try:
        saved = tuple(st["carry"])
        if len(saved) != n_leaves:
            return None
        x = torch.as_tensor(np.array(saved[0]))
        if x.shape != x0.shape or x.dtype != x0.dtype:
            return None
        x = x.to(x0.device)
        if not torch.equal(x, x0):
            return None
        rest = [torch.as_tensor(np.array(a)).to(x0.device)
                for a in saved[1:]]
    except (KeyError, TypeError, ValueError):
        return None
    return (x, *rest)


def _minimize_jax_bfgs(pb: OptimizationProblem, num_epochs: int,
                       timed: bool = False):
    """Dense BFGS on the device, in one of two variants, as the JAX
    package picks them:

    * ``bfgs_plain`` when some training loss gives no residual vector (a
      fused objective, the main path): each line-search trial is one value
      and gradient of the global loss (``pb.flat_value_and_grad``);
    * ``bfgs_paired`` when every training loss is a LossMeanSquares, in
      float64: each trial evaluates the stacked residuals R and 2·JᵀR, and
      the line search runs on the loss change
      Δφ(a) = Σ (R(x+a·d) − R(x))·(R(x+a·d) + R(x)), resolved at the scale
      of Δφ rather than of the loss.

    The float32 split-parameter variant (``bfgs_split``) is not ported.
    Per iteration: d = −H·g (steepest descent when d is not a descent
    direction), the line search, the value and gradient at the new point; a
    step with a non-finite loss, point or gradient is rejected and counts
    as a failed search, after which H restarts at I.  The carry lives on the
    device; ``pb.last_opt_state = {"kind", "carry"}`` is published at every
    log point, and a checkpointed carry of the same kind is adopted when its
    parameters equal the current ones bit for bit.  ``pb.bfgs_counts``
    counts iterations, line-search trials and evaluations; with ``timed``
    ``pb.bfgs_times`` gets, per iteration, the seconds of the direction, the
    evaluations and the H update (the device synchronised at each
    boundary)."""
    x0 = pb.get_flat()
    dtype, device = x0.dtype, x0.device
    n = x0.shape[0]
    residual_losses = all(type(l) is LossMeanSquares for l in pb.losses)
    if not residual_losses:
        kind = "bfgs_plain"
    elif dtype == torch.float32:
        raise NotImplementedError(
            "minimize(pb, 'jax', 'BFGS') in float32 with residual losses "
            "takes the split-parameter carry (bfgs_split), which is not "
            f"ported yet (ROADMAP.md, port queue 1, item {_SPLIT_ITEM})")
    else:
        kind = "bfgs_paired"

    counts = {"iterations": 0, "trials": 0, "evaluations": 0}
    pb.bfgs_counts = counts
    pb.bfgs_times = []
    part, tick = {}, time.perf_counter()

    def lap(key):
        nonlocal tick
        if timed:
            _sync(device)
            now = time.perf_counter()
            part[key] = part.get(key, 0.0) + now - tick
            tick = now

    def vg(x):
        counts["evaluations"] += 1
        return pb.flat_value_and_grad(x)

    def res_grad(x):
        counts["evaluations"] += 1
        return pb.residuals_and_grad(x)

    def direction(H, g):
        d = -(H @ g)
        dg = torch.dot(d, g)
        bad = dg >= 0
        d = torch.where(bad, -g, d)
        dg = torch.where(bad, -torch.dot(g, g), dg)
        lap("direction")
        return d, dg

    def search(f_1d, f0, dg):
        def trial(a):
            counts["trials"] += 1
            return f_1d(a)

        alpha, _ = _wolfe_zoom_linesearch(trial, f0, dg)
        counts["trials"] -= 1  # the re-evaluation at the returned alpha
        return torch.where(torch.isfinite(alpha), alpha, 0.0)

    def step_plain(carry):
        x, f, g, H, first = carry
        d, dg = direction(H, g)

        def f_1d(a):
            fa, ga_vec = vg(x + a * d)
            return fa, torch.dot(ga_vec, d)

        alpha = search(f_1d, f, dg)
        x_new = x + alpha * d
        f_new, g_new = vg(x_new)
        finite = _all_finite(f_new, x_new, g_new)
        x_new = torch.where(finite, x_new, x)
        f_new = torch.where(finite, f_new, f)
        g_new = torch.where(finite, g_new, g)
        failed = (alpha == 0.0) | ~finite
        lap("evaluations")
        H_new, first_new = _bfgs_update_H(H, x_new - x, g_new - g, first,
                                          failed)
        lap("update")
        return x_new, f_new, g_new, H_new, first_new

    def step_paired(carry):
        x, f, r, g, H, first = carry
        d, dg = direction(H, g)

        def d_1d(a):
            ra, ga_vec = res_grad(x + a * d)
            return torch.dot(ra - r, ra + r), torch.dot(ga_vec, d)

        # φ(0) = 0 in Δ-space: Armijo reads Δφ(a) ≤ c1·a·φ'(0)
        alpha = search(d_1d, torch.zeros_like(f), dg)
        x_new = x + alpha * d
        r_new, g_new = res_grad(x_new)
        f_new = f + torch.dot(r_new - r, r_new + r)
        finite = _all_finite(f_new, x_new, g_new, r_new)
        x_new = torch.where(finite, x_new, x)
        f_new = torch.where(finite, f_new, f)
        g_new = torch.where(finite, g_new, g)
        r_new = torch.where(finite, r_new, r)
        failed = (alpha == 0.0) | ~finite
        lap("evaluations")
        H_new, first_new = _bfgs_update_H(H, x_new - x, g_new - g, first,
                                          failed)
        lap("update")
        return x_new, f_new, r_new, g_new, H_new, first_new

    step = step_plain if kind == "bfgs_plain" else step_paired
    n_leaves = 5 if kind == "bfgs_plain" else 6
    carry = None
    st = _consume_resume_state(pb, kind)
    if st is not None:
        carry = _adopt_carry(st, x0, n_leaves)
    if carry is None:
        eye = torch.eye(n, dtype=dtype, device=device)
        first = torch.tensor(True, device=device)
        if kind == "bfgs_plain":
            f0, g0 = vg(x0)
            carry = (x0, f0, g0, eye, first)
        else:
            r0, g0 = res_grad(x0)
            carry = (x0, torch.dot(r0, r0), r0, g0, eye, first)

    pb.history.start_round("jax_BFGS")
    pb.last_round_name = "jax_BFGS"
    t0 = time.perf_counter()
    # published before the iteration-0 log point: a checkpoint written there
    # must keep a carry just adopted from a resume
    pb.last_opt_state = {"kind": kind, "carry": carry}
    _log_point(pb, 0, x0)
    done = 0
    for target in _log_iters(num_epochs, LOG_STRIDE)[1:]:
        for _ in range(target - done):
            if timed:
                _sync(device)
                part = {}
                pb.bfgs_times.append(part)
            tick = time.perf_counter()
            carry = step(carry)
            counts["iterations"] += 1
        done = target
        pb.last_opt_state = {"kind": kind, "carry": carry}
        _log_point(pb, done, carry[0])
    pb.set_flat(carry[0])
    pb.history.add_wall_time(time.perf_counter() - t0)
    pb.fire_callbacks(pb.history.iters[-1], force=True)
    return pb.params


# ---------------------------------------------------------------------------
# L-BFGS on the device (round jax_L-BFGS)
# ---------------------------------------------------------------------------

class LBFGSState:
    """``optax.ScaleByLBFGSState`` on flat vectors: the previous parameters
    and updates, the ring of parameter and update differences (one row per
    slot) and their weights 1/⟨Δu, Δw⟩.  The weights are float64 whatever
    the parameters' dtype, as optax's ``jnp.zeros(memory_size)`` is under
    x64; the count is a host integer."""

    def __init__(self, params: torch.Tensor, memory_size: int):
        m, n = int(memory_size), params.shape[0]
        self.count = 0
        self.params = torch.zeros_like(params)
        self.updates = torch.zeros_like(params)
        self.diff_params_memory = params.new_zeros((m, n))
        self.diff_updates_memory = params.new_zeros((m, n))
        self.weights_memory = torch.zeros(m, dtype=torch.float64,
                                          device=params.device)

    def as_dict(self) -> dict:
        return {"count": self.count, "params": self.params,
                "updates": self.updates,
                "diff_params_memory": self.diff_params_memory,
                "diff_updates_memory": self.diff_updates_memory,
                "weights_memory": self.weights_memory}


def _precondition_by_lbfgs(updates, diff_params_memory, diff_updates_memory,
                           weights_memory, identity_scale, memory_idx: int):
    """optax's two-loop recursion over every slot of the ring, in the order
    (memory_idx + arange(m)) % m: reversed for the right product, forward
    for the left one.  An empty slot has weight 0 and leaves the vector as
    it is.  The coefficients are float64 products (the weights' dtype) and
    each axpy runs in float64 before it is rounded to the vector's dtype,
    as optax's promotions do.  Device ops only: no host read."""
    m = weights_memory.shape[0]
    dtype = updates.dtype
    indices = [(memory_idx + i) % m for i in range(m)]
    vec = updates
    alphas = {}
    for i in reversed(indices):
        alpha = weights_memory[i] * torch.dot(diff_params_memory[i], vec)
        alphas[i] = alpha
        vec = (vec.double() - alpha * diff_updates_memory[i].double()
               ).to(dtype)
    vec = identity_scale * vec
    for i in indices:
        beta = weights_memory[i] * torch.dot(diff_updates_memory[i], vec)
        vec = (vec.double() + (alphas[i] - beta)
               * diff_params_memory[i].double()).to(dtype)
    return vec


def _scale_by_lbfgs(updates: torch.Tensor, state: LBFGSState,
                    params: torch.Tensor):
    """``optax.scale_by_lbfgs``'s update (with ``scale_init_precond``, as
    ``optax.lbfgs`` sets it): store the newest difference pair
    at slot (count − 1) % m (zeros at count 0), scale the identity by
    ⟨Δu, Δw⟩/‖Δu‖² (min(1, 1/‖u‖) at count 0), then the two-loop product.
    Returns the preconditioned updates; ``state`` moves on in place."""
    m = state.weights_memory.shape[0]
    memory_idx = state.count % m
    prev_memory_idx = (state.count - 1) % m
    if state.count > 0:
        diff_params = params - state.params
        diff_updates = updates - state.updates
        vdot = torch.dot(diff_updates, diff_params)
        weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
    else:
        diff_params = torch.zeros_like(params)
        diff_updates = torch.zeros_like(updates)
        vdot = weight = torch.zeros((), dtype=params.dtype,
                                    device=params.device)
    state.diff_params_memory[prev_memory_idx] = diff_params
    state.diff_updates_memory[prev_memory_idx] = diff_updates
    state.weights_memory[prev_memory_idx] = weight
    if state.count > 0:
        denominator = torch.dot(diff_updates, diff_updates)
        identity_scale = torch.where(
            denominator > 0.0,
            vdot / torch.where(denominator > 0.0, denominator, 1.0), 1.0)
    else:
        norm = torch.sqrt(torch.dot(updates, updates))
        identity_scale = torch.clamp_max(1.0 / norm, 1.0)
    precond = _precondition_by_lbfgs(
        updates, state.diff_params_memory, state.diff_updates_memory,
        state.weights_memory, identity_scale, memory_idx)
    state.count += 1
    state.params = params
    state.updates = updates
    return precond


# optax.lbfgs's memory in the JAX package's round (tpinn/optimize.py:200)
_LBFGS_MEMORY = 50


def _minimize_jax_lbfgs(pb: OptimizationProblem, num_epochs: int,
                        timed: bool = False):
    """optax's ``lbfgs(memory_size=50, linesearch=scale_by_zoom_linesearch(
    max_linesearch_steps=30, initial_guess_strategy="one"))`` on the flat
    device vector, driven as ``optax.value_and_grad_from_state`` drives it:
    an iteration evaluates the loss only when the line search's last value
    is inf or NaN (the first iteration, or a search that ended outside the
    domain), and otherwise takes the value and gradient the search ended
    on.  Per iteration: the direction d = −(two-loop product of g), then
    the zoom line search along d (each trial one value and gradient, the
    host reading one flag tensor), then x ← x + η·d.

    The state lives on the device; ``pb.last_opt_state = {"kind":
    "lbfgs", ...}`` is published at every log point, and, as in the JAX
    package, no round adopts it: a resumed L-BFGS round restarts from the
    parameters alone.  ``pb.lbfgs_counts`` counts iterations, line-search
    trials and evaluations; with ``timed`` ``pb.lbfgs_times`` gets, per
    iteration, the seconds of the direction and of the evaluations (the
    line search with its trials), the device synchronised at each
    boundary."""
    x = pb.get_flat()
    device = x.device
    counts = {"iterations": 0, "trials": 0, "evaluations": 0}
    pb.lbfgs_counts = counts
    pb.lbfgs_times = []

    def vg(theta):
        counts["evaluations"] += 1
        return pb.flat_value_and_grad(theta)

    def trial(theta):
        counts["trials"] += 1
        return vg(theta)

    lbfgs = LBFGSState(x, _LBFGS_MEMORY)
    linesearch = ScaleByZoomLinesearch(max_linesearch_steps=30)
    ls_state = linesearch.init(x)

    def publish():
        pb.last_opt_state = {"kind": "lbfgs", "lbfgs": lbfgs.as_dict(),
                             "learning_rate": ls_state.learning_rate,
                             "value": ls_state.value, "grad": ls_state.grad}

    def step(x, ls_state):
        if ls_state.value_nonfinite:
            value, grad = vg(x)
        else:
            value, grad = ls_state.value, ls_state.grad
        d = -1.0 * _scale_by_lbfgs(grad, lbfgs, x)
        if timed:
            _sync(device)
            part["direction"] = time.perf_counter() - tick
        upd, ls_state = linesearch.update(d, ls_state, x, value=value,
                                          grad=grad, value_and_grad_fn=trial)
        x = x + upd
        if timed:
            _sync(device)
            part["evaluations"] = time.perf_counter() - tick - \
                part["direction"]
        return x, ls_state

    pb.history.start_round("jax_L-BFGS")
    pb.last_round_name = "jax_L-BFGS"
    t0 = time.perf_counter()
    publish()
    _log_point(pb, 0, x)
    done = 0
    part, tick = {}, time.perf_counter()
    for target in _log_iters(num_epochs, LOG_STRIDE)[1:]:
        for _ in range(target - done):
            if timed:
                _sync(device)
                part = {}
                pb.lbfgs_times.append(part)
            tick = time.perf_counter()
            x, ls_state = step(x, ls_state)
            counts["iterations"] += 1
        done = target
        publish()
        _log_point(pb, done, x)
    pb.set_flat(x)
    pb.history.add_wall_time(time.perf_counter() - t0)
    pb.fire_callbacks(pb.history.iters[-1], force=True)
    return pb.params


# ---------------------------------------------------------------------------
# Levenberg–Marquardt (round jax_LM)
# ---------------------------------------------------------------------------

_NOT_PORTED = "is not ported yet (ROADMAP.md, port queue 1, item 8)"


def _collect_point_entries(pb: OptimizationProblem, r_batch: torch.Tensor):
    """Per-point residual entries [(fn, args, scale)] for the fast Gram,
    from every training loss's ``point_residual``.  The stacked per-point
    evaluation is held against the batch closures ``r_batch`` at the same
    parameters (rtol 1e-4), so a mis-wired ``point_residual`` (wrong rhs,
    stale points) cannot make the round optimize another objective.  Where
    the JAX package falls back to its chunked forward-mode Jacobian, the
    port raises: that Jacobian is not ported."""
    entries = []
    for loss in pb.losses:
        pr = getattr(loss, "point_residual", None)
        if pr is None:
            raise NotImplementedError(
                f"loss {loss.name!r} has no point_residual; the LM round's "
                f"chunked forward-mode Jacobian {_NOT_PORTED}")
        fn, args = pr
        n_rows = int(args[0].shape[0])
        scale = float(np.sqrt(loss.weight / n_rows) / loss.normalization)
        entries.append((fn, tuple(args), scale))

    theta = torch.as_tensor(pb.get_vector(), dtype=r_batch.dtype,
                            device=r_batch.device)
    params = pb.unravel(theta)
    with torch.no_grad():
        parts = [torch.func.vmap(fn, in_dims=(None,) + (0,) * len(args))(
            params, *args).reshape(-1) * scale for fn, args, scale in entries]
    r_pts = torch.cat(parts).cpu().numpy()
    r_b = r_batch.cpu().numpy()
    if r_pts.shape != r_b.shape:
        raise NotImplementedError(
            f"point_residual stack shape {r_pts.shape} != batch "
            f"{r_b.shape}; the chunked forward-mode Jacobian {_NOT_PORTED}")
    atol = 1e-5 * float(np.max(np.abs(r_b)) + 1e-30)
    if not np.allclose(r_pts, r_b, rtol=1e-4, atol=atol):
        worst = float(np.max(np.abs(r_pts - r_b)))
        raise NotImplementedError(
            f"point_residual stack deviates from the batch closures (max "
            f"|Δ| {worst:.3e}); the chunked forward-mode Jacobian "
            f"{_NOT_PORTED}")
    return entries


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _minimize_lm(pb: OptimizationProblem, num_epochs: int):
    """Levenberg–Marquardt: damped Gauss–Newton on the stacked residuals
    (``pb.residuals_at``), whose squared norm is the global loss.

    Per iteration: the residuals at θ; JᵀJ and Jᵀr from the per-point Gram
    (row i of J is the parameter gradient of residual component i, which
    depends on one point only: ``torch.func.vmap`` of ``grad`` of each
    loss's ``point_residual``, then GᵀG and Gᵀr on the device); JᵀJ to the
    host and one ``numpy.linalg.eigh``, after which the damped step
    δ(λ) = −V (Λ + λ)⁻¹ Vᵀ Jᵀr costs O(P²) for any λ; candidates accepted
    when ||r₁||² − ||r₀||², taken as (r₁ − r₀)·(r₁ + r₀), is negative.
    Damping λ = μ·max(w) follows Marquardt: μ/3 on accept, ×10 on reject;
    μ above 1e12 with no acceptable step ends the round (at the floor).

    Float64 only, host eigendecomposition only: the float32 split carry,
    the device damping ladder (``TPINN_LM_SOLVER=device``), the chunked
    forward-mode Jacobian and resuming a checkpointed LM state are not
    ported and raise.  ``pb.lm_times`` gets, per iteration, the seconds
    spent in each part (residuals, gram, download, eigh, accept, log);
    ``pb.lm_normal_eqs`` the normal-equations map."""
    params0 = pb.params
    dtype, device = params0[0].dtype, params0[0].device
    if dtype != torch.float64:
        raise NotImplementedError(
            f"the LM round runs in float64; the float32 split-parameter "
            f"carry is not ported yet (ROADMAP.md, port queue 1, item "
            f"{_SPLIT_ITEM})")
    if os.environ.get("TPINN_LM_SOLVER", "auto") == "device":
        raise NotImplementedError(
            f"TPINN_LM_SOLVER=device: the on-device damping ladder "
            f"{_NOT_PORTED}")
    st = getattr(pb, "resume_opt_state", None)
    if isinstance(st, dict) and str(st.get("kind")) == "lm":
        raise NotImplementedError(f"resuming a checkpointed LM state "
                                  f"{_NOT_PORTED}")
    for loss in pb.losses:
        if type(loss) is not LossMeanSquares:
            raise ValueError(
                "minimize(pb, 'jax', 'LM') requires every training loss to "
                "expose a residual vector (LossMeanSquares); "
                f"{loss.name!r} is {type(loss).__name__}")

    theta64 = pb.get_vector()
    entries = _collect_point_entries(pb, pb.residuals_at(theta64))

    def gram_fast(theta: torch.Tensor):
        """JᵀJ and Jᵀr from the rows of J, one loss at a time stacked into
        G (N, P): one product for each over all losses."""
        Gs, rs = [], []
        for fn, args, scale in entries:
            def res_one(th, *rows, _fn=fn, _s=scale):
                return _fn(pb.unravel(th), *rows) * _s

            G, r = torch.func.vmap(torch.func.grad_and_value(res_one),
                                   in_dims=(None,) + (0,) * len(args))(
                theta, *args)
            Gs.append(G)
            rs.append(r)
        G, r = torch.cat(Gs), torch.cat(rs)
        return G.T @ G, G.T @ r

    # seconds of each part of every iteration, the device synchronised at
    # each boundary so that its work is charged to the part that queued it
    pb.lm_times = []
    tick, part = time.perf_counter(), {}

    def lap(key):
        nonlocal tick
        _sync(device)
        now = time.perf_counter()
        part[key] = part.get(key, 0.0) + now - tick
        tick = now

    def normal_eqs(theta64):
        """(r at θ on the device, JᵀJ, Jᵀr as float64 host arrays)."""
        r = pb.residuals_at(theta64)
        lap("residuals")
        theta = torch.as_tensor(theta64, dtype=dtype, device=device)
        JTJ, JTr = gram_fast(theta)
        lap("gram")
        out = (r, JTJ.cpu().numpy(), JTr.cpu().numpy().astype(np.float64))
        lap("download")
        return out

    pb.lm_normal_eqs = normal_eqs

    def pair_diff(r_new, r_cur) -> float:
        return float(torch.dot(r_new - r_cur, r_new + r_cur))

    pb.history.start_round("jax_LM")
    pb.last_round_name = "jax_LM"
    t0 = time.perf_counter()
    mu = 1e-3  # relative damping: λ = mu·max(w)
    pb.last_opt_state = {"kind": "lm", "theta64": theta64.copy(),
                         "mu": float(mu)}
    _log_point(pb, 0, theta64)
    log_targets = set(_log_iters(num_epochs, LOG_STRIDE)[1:])
    tick = time.perf_counter()
    for it in range(1, num_epochs + 1):
        part = {}
        pb.lm_times.append(part)
        r_cur, JTJ, JTr = normal_eqs(theta64)
        w, V = np.linalg.eigh(JTJ)
        lap("eigh")
        w = np.maximum(w, 0.0)
        w_max = float(w[-1]) if w.size else 0.0
        converged = not np.isfinite(w_max) or w_max <= 0
        accepted = False
        c = V.T @ JTr
        while not converged:
            lam = mu * w_max + np.finfo(np.float64).tiny
            delta64 = -(V @ (c / (w + lam)))
            df = pair_diff(pb.residuals_at(theta64 + delta64), r_cur)
            if np.isfinite(df) and df < 0:
                theta64 = theta64 + delta64
                mu = max(mu / 3.0, 1e-14)
                accepted = True
                break
            mu *= 10.0
            if mu > 1e12:  # no damping yields progress: at the floor
                converged = True
        lap("accept")
        pb.last_opt_state = {"kind": "lm", "theta64": theta64.copy(),
                             "mu": float(mu)}
        if it in log_targets or converged or not accepted:
            _log_point(pb, it, theta64)
            lap("log")
        if converged:
            break

    pb.set_vector(theta64)
    pb.history.add_wall_time(time.perf_counter() - t0)
    pb.fire_callbacks(pb.history.iters[-1], force=True)
    return pb.params


@contextlib.contextmanager
def _ieee_products():
    """IEEE float32 matrix products (no TF32) for a second-order round; the
    caller's settings come back afterwards.  TF32's ~1e-3 relative error
    breaks line-search certifications and accept tests."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def minimize(pb: OptimizationProblem, strategy: str, optimizer=None,
             num_epochs: int = 100, timed: bool = False):
    """Run one optimization round; appends to pb.history and updates the
    model's parameters in place.  ``timed`` makes the dense BFGS and the
    L-BFGS rounds record their iteration split (``pb.bfgs_times``,
    ``pb.lbfgs_times``)."""
    strategy = strategy.lower()
    if strategy in ("keras", "adam"):
        optimizer = _first_order_optimizer(optimizer)
        return _minimize_first_order(pb, optimizer, num_epochs,
                                     round_name=f"keras_{optimizer.name}")
    if strategy == "scipy":
        method = optimizer if isinstance(optimizer, str) else "BFGS"
        with _ieee_products():
            return _minimize_scipy(pb, method, num_epochs)
    if strategy in ("jax", "lbfgs"):
        method = optimizer if isinstance(optimizer, str) else "L-BFGS"
        key = method.upper().replace("-", "").replace("_", "")
        if key == "BFGS":
            with _ieee_products():
                return _minimize_jax_bfgs(pb, num_epochs, timed=timed)
        if key in ("LM", "GN", "LEVENBERGMARQUARDT", "GAUSSNEWTON"):
            with _ieee_products():
                return _minimize_lm(pb, num_epochs)
        with _ieee_products():
            return _minimize_jax_lbfgs(pb, num_epochs, timed=timed)
    raise ValueError(f"unknown strategy {strategy!r}")
