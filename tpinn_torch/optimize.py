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
  per-point Gram on the device (else from the chunked Jacobian), then damped
  steps accepted by a paired-difference test, through one host
  eigendecomposition per iteration or, on the card, a damping ladder of
  Cholesky solves on the device.  In float32 both BFGS (on residual losses)
  and LM carry the parameters as a split pair.

Second-order rounds run with IEEE float32 products (no TF32).

Under a point mesh (``pb.mesh``) every round runs on every rank with the
same replicated state: each evaluation sums the ranks' shares in one
collective (``OptimizationProblem``), and every branch (line-search
trials, BFGS's curvature guard, LM's accept test and rungs) reads summed
values only.  The host steps, scipy's round and LM's ``numpy.linalg.eigh``,
run on every rank on the same summed inputs and give the same bits, so θ
stays identical on every rank.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch

from tpinn_torch import sharding
from tpinn_torch.history import LOG_STRIDE
from tpinn_torch.kernels.lbfgs_direction import lbfgs_direction
from tpinn_torch.linesearch import ScaleByZoomLinesearch
from tpinn_torch.losses import LossMeanSquares
from tpinn_torch.optimizers import Adam, Optimizer
from tpinn_torch.problem import OptimizationProblem
from tpinn_torch.profiling import span


def _log_point(pb: OptimizationProblem, iter_in_round: int,
               theta=None) -> None:
    """Publish the logged parameters (a flat device tensor or a host
    vector, when given) into the model, append the evaluation to the
    history, then fire the callbacks at the global iteration, so that a
    checkpoint taken there holds the state the history claims."""
    with span("log_point"):
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
            with span("step"):
                _, grads = pb.loss_and_grads(params)
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
        with span("host_read"):
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


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, err) with s + err == a + b exactly (Knuth's TwoSum, branch
    free): exact in IEEE arithmetic with each operation rounded on its own,
    as eager PyTorch runs them (one kernel per operation, no reassociation,
    no fused multiply-add in a sum)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _df_add(hi: torch.Tensor, lo: torch.Tensor, delta: torch.Tensor):
    """(hi, lo) + delta as a renormalized two-float pair, error free."""
    s, err = _two_sum(hi, delta)
    lo2 = lo + err
    return _two_sum(s, lo2)


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
    """Dense BFGS on the device, in one of three variants, as the JAX
    package picks them:

    * ``bfgs_plain`` when some training loss gives no residual vector (a
      fused objective, the main path): each line-search trial is one value
      and gradient of the global loss (``pb.flat_value_and_grad``);
    * ``bfgs_paired`` when every training loss is a LossMeanSquares, in
      float64: each trial evaluates the stacked residuals R and 2·JᵀR, and
      the line search runs on the loss change
      Δφ(a) = Σ (R(x+a·d) − R(x))·(R(x+a·d) + R(x)), resolved at the scale
      of Δφ rather than of the loss;
    * ``bfgs_split`` for the same losses in float32: the parameters are an
      unevaluated two-float pair (hi, lo), moved by the error-free
      ``_df_add``, so a step below ulp(θ) still moves them; each trial
      evaluates r(hi), dr = J(hi)·lo and 2·J(hi)ᵀ(r + dr)
      (``pb.residuals_split``) and differences each channel before adding
      them: Δφ = ((r − r₀) + (dr − dr₀))·((r + r₀) + (dr + dr₀)).  The H
      update takes s = (hi₁ − hi) + (lo₁ − lo); ``pb.last_theta64`` gets
      hi + lo in float64.

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
        kind = "bfgs_split"
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

    def res_grad(x, r_ref=None):
        counts["evaluations"] += 1
        return pb.residuals_and_grad(x, r_ref)

    def eval_ch(hi, lo, ref=None):
        counts["evaluations"] += 1
        return pb.residuals_split(hi, lo, ref)

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
            _, ga_vec, dphi = res_grad(x + a * d, r)
            return dphi, torch.dot(ga_vec, d)

        # φ(0) = 0 in Δ-space: Armijo reads Δφ(a) ≤ c1·a·φ'(0)
        alpha = search(d_1d, torch.zeros_like(f), dg)
        x_new = x + alpha * d
        r_new, g_new, df = res_grad(x_new, r)
        f_new = f + df
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

    def step_split(carry):
        hi, lo, f, r, dr, g, H, first = carry
        d, dg = direction(H, g)

        def d_1d(a):
            hia, loa = _df_add(hi, lo, a * d)
            # channel by channel: the r-channel cancels bit for bit while
            # hi is unchanged, and the dr-channel resolves sub-ulp steps
            _, _, ga_vec, dphi = eval_ch(hia, loa, (r, dr))
            return dphi, torch.dot(ga_vec, d)

        alpha = search(d_1d, torch.zeros_like(f), dg)
        hi_n, lo_n = _df_add(hi, lo, alpha * d)
        r_n, dr_n, g_n, df = eval_ch(hi_n, lo_n, (r, dr))
        f_n = f + df
        finite = _all_finite(f_n, hi_n, g_n, r_n, dr_n)
        hi_n = torch.where(finite, hi_n, hi)
        lo_n = torch.where(finite, lo_n, lo)
        f_n = torch.where(finite, f_n, f)
        g_n = torch.where(finite, g_n, g)
        r_n = torch.where(finite, r_n, r)
        dr_n = torch.where(finite, dr_n, dr)
        failed = (alpha == 0.0) | ~finite
        lap("evaluations")
        s = (hi_n - hi) + (lo_n - lo)
        H_new, first_new = _bfgs_update_H(H, s, g_n - g, first, failed)
        lap("update")
        return hi_n, lo_n, f_n, r_n, dr_n, g_n, H_new, first_new

    step, n_leaves = {"bfgs_plain": (step_plain, 5),
                      "bfgs_paired": (step_paired, 6),
                      "bfgs_split": (step_split, 8)}[kind]
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
        elif kind == "bfgs_split":
            lo0 = torch.zeros_like(x0)
            r0, dr0, g0, f0 = eval_ch(x0, lo0)
            carry = (x0, lo0, f0, r0, dr0, g0, eye, first)
        else:
            r0, g0, f0 = res_grad(x0)
            carry = (x0, f0, r0, g0, eye, first)

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
    if kind == "bfgs_split":
        # the two-float carry; the parameters below are its hi channel
        pb.last_theta64 = (carry[0].cpu().numpy().astype(np.float64)
                           + carry[1].cpu().numpy().astype(np.float64))
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


def _store_pair(updates: torch.Tensor, state: LBFGSState,
                params: torch.Tensor) -> torch.Tensor:
    """The plain version's first half: the newest difference pair and its
    weight stored at slot (count − 1) % m (zeros at count 0); returns the
    identity scale ⟨Δu, Δw⟩/‖Δu‖² (min(1, 1/‖u‖) at count 0)."""
    prev_memory_idx = (state.count - 1) % state.weights_memory.shape[0]
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
        return torch.where(
            denominator > 0.0,
            vdot / torch.where(denominator > 0.0, denominator, 1.0), 1.0)
    norm = torch.sqrt(torch.dot(updates, updates))
    return torch.clamp_max(1.0 / norm, 1.0)


def _scale_by_lbfgs(updates: torch.Tensor, state: LBFGSState,
                    params: torch.Tensor):
    """The descent direction of ``optax.lbfgs``: ``optax.scale_by_lbfgs``'s
    update (with ``scale_init_precond``, as ``optax.lbfgs`` sets it),
    negated, as ``optax.lbfgs`` does before its line search.  Stores the newest difference pair
    at slot (count − 1) % m (zeros at count 0), scales the identity by
    ⟨Δu, Δw⟩/‖Δu‖² (min(1, 1/‖u‖) at count 0), then takes the two-loop
    product; ``state`` moves on in place.  A CUDA vector takes the one
    launch of ``kernels.lbfgs_direction``; a CPU one its plain version,
    ``_store_pair`` and ``_precondition_by_lbfgs``."""
    if updates.is_cuda:
        out = lbfgs_direction(
            updates, params, state.updates, state.params,
            state.diff_params_memory, state.diff_updates_memory,
            state.weights_memory, state.count)
    else:
        identity_scale = _store_pair(updates, state, params)
        out = -1.0 * _precondition_by_lbfgs(
            updates, state.diff_params_memory, state.diff_updates_memory,
            state.weights_memory, identity_scale,
            state.count % state.weights_memory.shape[0])
    state.count += 1
    state.params = params
    state.updates = updates
    return out


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
        with span("lbfgs.direction"):
            d = _scale_by_lbfgs(grad, lbfgs, x)
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
            with span("step"):
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

def _collect_point_entries(pb: OptimizationProblem, r_batch: torch.Tensor):
    """Per-point residual entries [(fn, args, scale)] for the fast Gram,
    from every training loss's ``point_residual``.  The stacked per-point
    evaluation is held against the batch closures ``r_batch`` at the same
    parameters (rtol 1e-4, atol 1e-5 of the largest), so a mis-wired
    ``point_residual`` (wrong rhs, stale points) cannot make the round
    optimize another objective.  None, with the JAX package's message,
    when some loss has none or the check fails: the round then takes the
    chunked Jacobian.  Under a mesh the entries are this rank's rows (each
    scaled by the global count, a replicated loss's on rank 0 alone) and
    the check holds only when it holds on every rank."""
    if any(getattr(l, "point_residual", None) is None for l in pb.losses):
        return None
    entries = []
    for loss in pb.losses:
        if not pb._counts(loss):
            continue
        fn, args = loss.point_residual
        n_rows = int(args[0].shape[0])
        if loss.mesh is not None:
            n_rows *= pb._world
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
    ok = r_pts.shape == r_b.shape
    if not ok:
        print(f"  LM: point_residual stack shape {r_pts.shape} != batch "
              f"{r_b.shape}; falling back to chunked jacobian", flush=True)
    else:
        atol = 1e-5 * float(np.max(np.abs(r_b)) + 1e-30)
        ok = bool(np.allclose(r_pts, r_b, rtol=1e-4, atol=atol))
        if not ok:
            worst = float(np.max(np.abs(r_pts - r_b)))
            print(f"  LM: point_residual stack deviates from batch closures "
                  f"(max |Δ| {worst:.3e}); falling back to chunked jacobian",
                  flush=True)
    if not sharding.all_ranks(pb.mesh, ok, r_batch.device):
        return None
    return entries


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_TINY64 = float(np.finfo(np.float64).tiny)
# power iterations for the ladder's largest eigenvalue of JᵀJ
_POWER_ITERS = 24


def _minimize_lm(pb: OptimizationProblem, num_epochs: int):
    """Levenberg–Marquardt: damped Gauss–Newton on the stacked residuals
    (``pb.residuals_at``), whose squared norm is the global loss.

    Per iteration: the residuals at θ, then JᵀJ and Jᵀr, then a ladder of
    damped steps.  JᵀJ and Jᵀr come from the per-point Gram (row i of J is
    the parameter gradient of residual component i, which depends on one
    point only: ``torch.func.vmap`` of ``grad`` of each loss's
    ``point_residual``, then GᵀG and Gᵀr on the device) when every loss has
    a ``point_residual`` that agrees with its batch closure at θ0
    (``pb.lm_used_fast_gram``); else from the chunked Jacobian, J built in
    blocks of ``problem.JAC_CHUNK`` parameter tangents through the losses
    themselves (``pb.residuals_jacobian``).  A candidate is accepted when
    ||r₁||² − ||r₀||², taken as (r₁ − r₀)·(r₁ + r₀), is finite and
    negative; the damping λ = μ·w_max follows Marquardt: μ/3 (floor 1e-14)
    on accept, ×10 on reject, and μ above 1e12 with no acceptable step ends
    the round (at the floor).

    The ladder takes one of two solvers (``TPINN_LM_SOLVER``; ``pb.lm_solver``):

    * "host_eigh": JᵀJ to the host and one ``numpy.linalg.eigh``, after
      which a rung δ(λ) = −V (Λ + λ)⁻¹ Vᵀ Jᵀr costs O(P²) for any λ;
    * "device_ladder": everything on the device: w_max by 24 power
      iterations from Jᵀr/‖Jᵀr‖, then per rung one Cholesky factorization
      of JᵀJ + λI (a matrix that is not positive definite is a rejected
      rung), its solve and the candidate's residuals; the host reads one
      flag tensor per rung.

    ``device`` and ``host`` force one; ``auto`` (the default) takes the
    device ladder when the parameters lie on the card in float64 and the
    host loop elsewhere: the JAX package's rule of the device on its
    accelerator and host LAPACK on the CPU, the card being the port's
    accelerator.

    In float32 θ lives in host float64 as a split carry (hi, lo), hi its
    float32 rounding: a step below ulp(θ) still changes the evaluation,
    which is r(hi) and dr = J(hi)·lo in two channels, the accept test
    differencing each channel before adding them.  Jᵀr is taken at hi and
    corrected by JᵀJ·lo in host float64 (the chunked route keeps Jᵀr and
    Jᵀdr apart and adds them there).  The split carry always takes the
    host loop.

    A checkpointed state of kind "lm" is adopted when its θ, rounded to
    the working dtype, equals the parameters bit for bit (μ clamped to
    [1e-14, 1e8]); a malformed one cold-starts.  ``pb.last_opt_state``
    holds θ (float64) and μ from before the iteration-0 log point on;
    ``pb.last_theta64`` the final carry.  ``pb.lm_times`` gets, per
    iteration, the seconds of each part (host loop: residuals, gram,
    download, eigh, accept; device ladder: residuals, gram, power,
    cholesky, solve, candidate; and log), the device synchronised at each
    boundary; ``pb.lm_rungs`` the rungs of each iteration;
    ``pb.lm_normal_eqs`` the host loop's normal-equations map."""
    params0 = pb.params
    dtype, device = params0[0].dtype, params0[0].device
    for loss in pb.losses:
        if type(loss) is not LossMeanSquares:
            raise ValueError(
                "minimize(pb, 'jax', 'LM') requires every training loss to "
                "expose a residual vector (LossMeanSquares); "
                f"{loss.name!r} is {type(loss).__name__}")
    split = dtype == torch.float32

    theta0_64 = pb.get_vector()
    entries = _collect_point_entries(pb, pb.residuals_at(theta0_64))
    pb.lm_used_fast_gram = entries is not None
    solver_env = os.environ.get("TPINN_LM_SOLVER", "auto")
    use_ladder = (not split) and (
        solver_env == "device"
        or (solver_env == "auto" and device.type == "cuda"))
    pb.lm_solver = "device_ladder" if use_ladder else "host_eigh"

    def to_dev(theta64: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(theta64, dtype=dtype, device=device)

    def split64(theta64: np.ndarray):
        hi = theta64.astype(np.float32)
        lo = (theta64 - hi.astype(np.float64)).astype(np.float32)
        return to_dev(hi), to_dev(lo)

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
        return pb.mesh_sum(G.T @ G, G.T @ r)

    # seconds of each part of every iteration, the device synchronised at
    # each boundary so that its work is charged to the part that queued it
    pb.lm_times = []
    pb.lm_rungs = []
    tick, part = time.perf_counter(), {}

    def lap(key):
        nonlocal tick
        _sync(device)
        now = time.perf_counter()
        part[key] = part.get(key, 0.0) + now - tick
        tick = now

    def eval_res(theta64: np.ndarray):
        """(r, None) at θ, or (r(hi), J(hi)·lo) under the split carry."""
        if split:
            return pb.residuals_jvp(*split64(theta64))
        return pb.residuals_at(theta64), None

    def normal_eqs(theta64: np.ndarray):
        """(residuals on the device, JᵀJ as a host array of the working
        dtype, Jᵀr in host float64) at θ; the residuals are a tensor, or
        the pair (r(hi), J(hi)·lo) under the split carry."""
        rv = eval_res(theta64)
        lap("residuals")
        hi = to_dev(theta64)
        JTr_lo = None
        if entries is not None:
            JTJ, JTr = gram_fast(hi)
        else:
            _, Jt = pb.residuals_jacobian(hi)
            if split:
                JTJ, JTr, JTr_lo = pb.mesh_sum(Jt @ Jt.T, Jt @ rv[0],
                                               Jt @ rv[1])
            else:
                JTJ, JTr = pb.mesh_sum(Jt @ Jt.T, Jt @ rv[0])
        lap("gram")
        JTJ = JTJ.cpu().numpy()
        JTr = JTr.cpu().numpy().astype(np.float64)
        if split:
            # Jᵀr's lo part in host float64: Jᵀdr kept apart on the
            # chunked route, JᵀJ·lo on the fast Gram's
            JTr = JTr + (
                JTr_lo.cpu().numpy().astype(np.float64) if JTr_lo is not None
                else JTJ.astype(np.float64)
                @ (theta64 - hi.cpu().numpy().astype(np.float64)))
        lap("download")
        return (rv if split else rv[0]), JTJ, JTr

    pb.lm_normal_eqs = normal_eqs

    def pair_diff(new, cur) -> float:
        (r1, d1), (r0, d0) = new, cur
        if d1 is None:
            df = torch.dot(r1 - r0, r1 + r0)
        else:
            df = torch.dot((r1 - r0) + (d1 - d0), (r1 + r0) + (d1 + d0))
        return float(pb.mesh_sum(df)[0])

    def ladder(theta, mu: float, JTJ, JTr, r_cur):
        """One iteration's damping ladder on the device: (θ, μ, accepted),
        the model left at θ."""
        n = JTJ.shape[0]
        nrm = torch.linalg.norm(JTr)
        v = torch.where(nrm > 0, JTr / (nrm + _TINY64), torch.full(
            (n,), 1.0 / math.sqrt(max(n, 1)), dtype=dtype, device=device))
        for _ in range(_POWER_ITERS):
            v2 = JTJ @ v
            v = v2 / (torch.linalg.norm(v2) + _TINY64)
        w_max = v @ (JTJ @ v)
        eye = torch.eye(n, dtype=dtype, device=device)
        mu_t = torch.tensor(mu, dtype=dtype, device=device)
        done = not bool(torch.isfinite(w_max) & (w_max > 0))
        lap("power")
        accepted, rungs = False, 0
        while not done:
            lam = mu_t * w_max + _TINY64
            L, info = torch.linalg.cholesky_ex(JTJ + lam * eye,
                                               check_errors=False)
            lap("cholesky")
            delta = -torch.cholesky_solve(JTr[:, None], L)[:, 0]
            lap("solve")
            th = theta + delta
            r = pb.residuals_flat(th)
            (df,) = pb.mesh_sum(torch.dot(r - r_cur, r + r_cur))
            ok = ((info == 0) & torch.isfinite(delta).all()
                  & torch.isfinite(df) & (df < 0))
            mu_rej = mu_t * 10.0
            mu_t = torch.where(ok, torch.clamp(mu_t / 3.0, min=1e-14), mu_rej)
            theta = torch.where(ok, th, theta)
            accepted, done = torch.stack((ok, ok | (mu_rej > 1e12))).tolist()
            rungs += 1
            lap("candidate")
        pb.set_flat(theta)
        pb.lm_rungs.append(rungs)
        return theta, float(mu_t), accepted

    pb.history.start_round("jax_LM")
    pb.last_round_name = "jax_LM"
    t0 = time.perf_counter()
    theta64 = theta0_64
    mu = 1e-3  # relative damping: λ = mu·max(w)
    st = _consume_resume_state(pb, "lm")
    if st is not None:
        try:
            saved = np.asarray(st["theta64"], np.float64)
            work = np.float32 if split else np.float64
            if (saved.shape == theta64.shape and np.array_equal(
                    saved.astype(work), theta64.astype(work))):
                theta64 = saved
                mu = min(max(float(st["mu"]), 1e-14), 1e8)
        except (KeyError, TypeError, ValueError):
            pass  # a malformed state: cold start
    # published before the iteration-0 log point: a checkpoint written there
    # must keep a carry just adopted from a resume
    pb.last_opt_state = {"kind": "lm", "theta64": theta64.copy(),
                         "mu": float(mu)}
    _log_point(pb, 0, theta0_64)
    log_targets = set(_log_iters(num_epochs, LOG_STRIDE)[1:])
    theta_dev = to_dev(theta64) if use_ladder else None
    tick = time.perf_counter()
    for it in range(1, num_epochs + 1):
        part = {}
        pb.lm_times.append(part)
        if use_ladder:
            if entries is not None:
                r_cur = pb.residuals_flat(theta_dev)
                lap("residuals")
                JTJ, JTr = gram_fast(theta_dev)
            else:
                # the residuals come with the Jacobian's linearization
                r_cur, Jt = pb.residuals_jacobian(theta_dev)
                JTJ, JTr = pb.mesh_sum(Jt @ Jt.T, Jt @ r_cur)
            lap("gram")
            theta_dev, mu, accepted = ladder(theta_dev, mu, JTJ, JTr, r_cur)
            converged = not accepted  # saturated, or an invalid w_max
            theta64 = theta_dev.cpu().numpy().astype(np.float64)
            logged = theta_dev
        else:
            r_cur, JTJ, JTr = normal_eqs(theta64)
            cur = r_cur if split else (r_cur, None)
            w, V = np.linalg.eigh(JTJ)
            lap("eigh")
            w = np.maximum(w, 0.0)
            w_max = float(w[-1]) if w.size else 0.0
            converged = not np.isfinite(w_max) or w_max <= 0
            accepted = False
            c = V.T @ JTr
            rungs = 0
            while not converged:
                lam = mu * w_max + _TINY64
                delta64 = -(V @ (c / (w + lam)))
                df = pair_diff(eval_res(theta64 + delta64), cur)
                rungs += 1
                if np.isfinite(df) and df < 0:
                    theta64 = theta64 + delta64
                    mu = max(mu / 3.0, 1e-14)
                    accepted = True
                    break
                mu *= 10.0
                if mu > 1e12:  # no damping yields progress: at the floor
                    converged = True
            pb.lm_rungs.append(rungs)
            lap("accept")
            logged = theta64
        pb.last_opt_state = {"kind": "lm", "theta64": theta64.copy(),
                             "mu": float(mu)}
        if it in log_targets or converged or not accepted:
            _log_point(pb, it, logged)
            lap("log")
        if converged:
            break

    pb.last_theta64 = theta64.copy()
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
    ``pb.lbfgs_times``).  The round is one ``round`` span
    (``tpinn_torch.profiling``)."""
    with span("round"):
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
