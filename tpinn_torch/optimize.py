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
* ``minimize(pb, "jax", "LM", num_epochs)`` runs Levenberg–Marquardt on the
  stacked residual vector (round ``jax_LM``): the normal equations from the
  per-point Gram on the device, one host eigendecomposition per iteration,
  and damped steps accepted by a paired-difference test.

The JAX package's on-device dense BFGS and L-BFGS rounds are not ported yet.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpinn_torch.history import LOG_STRIDE
from tpinn_torch.losses import LossMeanSquares
from tpinn_torch.optimizers import Adam, Optimizer
from tpinn_torch.problem import OptimizationProblem


def _log_point(pb: OptimizationProblem, iter_in_round: int) -> None:
    total, train, test = pb.eval_all()
    pb.history.append(iter_in_round, total, train, test)


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
    return params


def _minimize_scipy(pb: OptimizationProblem, method: str, num_epochs: int):
    from scipy import optimize as sciopt

    round_name = f"scipy_{method}"
    pb.history.start_round(round_name)
    t0 = time.perf_counter()
    x0 = pb.get_vector()
    _log_point(pb, 0)
    it = {"n": 0}

    def callback(xk):
        it["n"] += 1
        if it["n"] % LOG_STRIDE == 0:
            pb.set_vector(xk)
            _log_point(pb, it["n"])

    res = sciopt.minimize(pb.value_and_grad_vector, x0, jac=True,
                          method=method, callback=callback,
                          options={"maxiter": num_epochs})
    pb.set_vector(res.x)
    if it["n"] % LOG_STRIDE != 0:
        _log_point(pb, it["n"])
    pb.history.add_wall_time(time.perf_counter() - t0)
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
            f"carry {_NOT_PORTED}")
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
    t0 = time.perf_counter()
    mu = 1e-3  # relative damping: λ = mu·max(w)
    pb.last_opt_state = {"kind": "lm", "theta64": theta64.copy(),
                         "mu": float(mu)}
    pb.set_vector(theta64)
    _log_point(pb, 0)
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
            pb.set_vector(theta64)
            _log_point(pb, it)
            lap("log")
        if converged:
            break

    pb.set_vector(theta64)
    pb.history.add_wall_time(time.perf_counter() - t0)
    return pb.params


def minimize(pb: OptimizationProblem, strategy: str, optimizer=None,
             num_epochs: int = 100):
    """Run one optimization round; appends to pb.history and updates the
    model's parameters in place."""
    strategy = strategy.lower()
    if strategy in ("keras", "adam"):
        optimizer = _first_order_optimizer(optimizer)
        return _minimize_first_order(pb, optimizer, num_epochs,
                                     round_name=f"keras_{optimizer.name}")
    if strategy == "scipy":
        method = optimizer if isinstance(optimizer, str) else "BFGS"
        return _minimize_scipy(pb, method, num_epochs)
    if strategy in ("jax", "lbfgs"):
        method = optimizer if isinstance(optimizer, str) else "L-BFGS"
        key = method.upper().replace("-", "").replace("_", "")
        if key in ("LM", "GN", "LEVENBERGMARQUARDT", "GAUSSNEWTON"):
            return _minimize_lm(pb, num_epochs)
        item = 2 if key == "BFGS" else 4
        raise NotImplementedError(
            f"minimize(pb, {strategy!r}, {method!r}): the on-device "
            f"{'dense BFGS' if item == 2 else 'L-BFGS'} round is not ported "
            f"yet (ROADMAP.md, port queue 1, item {item})")
    raise ValueError(f"unknown strategy {strategy!r}")
