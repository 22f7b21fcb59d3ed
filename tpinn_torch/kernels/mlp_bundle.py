"""Fused Navier–Stokes residual kernels: torch side.

Two CUDA kernels (csrc/ns_residual.cu) replace the NS-residual Pallas kernels
of the JAX package:

* ``ns_residual_bwd`` — the one-pass backward: Taylor streams, residuals,
  cotangents, every dW/db and the three MSEs in one launch (plus a fixed-order
  reduction over blocks).  ``ns_residual_weighted_obj`` calls it with the loss
  weights as cotangents: weighted loss, log MSEs and parameter gradients from
  one pass.
* ``ns_residual_fwd`` — the forward: the three MSEs only.  It is the forward
  of ``ns_residual_mse``, whose backward is ``ns_residual_bwd``.

Beside each public function sits its plain PyTorch version (``*_plain``),
built on :func:`tpinn_torch.operators.mlp_taylor_batched` and autograd.  A
tensor on the CPU takes the plain version; a CUDA tensor launches the kernel
or raises.  ``LAUNCHES`` counts the launches of each kernel (one per wrapper
call that launches it).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tpinn_torch.operators import mlp_taylor_batched

MAX_LAYERS = 8  # Dense layers, head included
MAX_WIDTH = 64  # any layer's output width (two neurons per lane)
SMEM_LIMIT = 227 * 1024  # bytes of shared memory a block may use
D_OUT = 3
N_H = 2

LAUNCHES: Dict[str, int] = {"ns_residual_bwd": 0, "ns_residual_fwd": 0}
_PLANS: Dict[tuple, Tuple[int, int, int, int]] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# shapes and limits
# ---------------------------------------------------------------------------


def _phys_items(physics, norm) -> Tuple[float, ...]:
    """(nv, npre, scale, conv, visc, pres, time) as the kernels take them."""
    return (float(norm.norm_vel), float(norm.norm_pre),
            float(norm.residual_scale), float(physics.conv),
            float(physics.visc), float(physics.pres), float(physics.time))


def _expected_d_in(physics) -> int:
    return 3 if float(physics.time) != 0.0 else 2


def _widths(params) -> List[int]:
    return [int(p["kernel"].shape[0]) for p in params] + [
        int(params[-1]["kernel"].shape[1])]


def _check_layout(params, x, physics) -> List[int]:
    d_in = int(x.shape[1])
    expect = _expected_d_in(physics)
    if d_in != expect:
        # steady wants (x, y); unsteady wants (t, x, y): a mismatched column
        # count would silently misassign the Taylor streams
        raise ValueError(
            f"ns_residual: input has d_in={d_in} columns but expected "
            f"{expect} ({'unsteady (t,x,y)' if expect == 3 else 'steady (x,y)'})")
    widths = _widths(params)
    if widths[0] != d_in or widths[-1] != D_OUT:
        raise ValueError(f"ns_residual: widths {widths} do not map "
                         f"{d_in} inputs to (u, v, p)")
    return widths


def smem_elems(widths: Sequence[int], d_in: int, points: int,
               bwd: bool) -> int:
    """Shared-memory elements of one block (mirrors ``Layout::build`` in
    csrc/ns_residual.cu): weights with padded rows, the accumulators, and
    ``points`` per-point regions."""
    S = 1 + d_in + N_H
    L = len(widths) - 1
    total = sum(widths[l] * (widths[l + 1] + 1) + widths[l + 1]
                for l in range(L))
    maxw = max(widths[1:])
    n_acc = (sum((widths[l] + 1) * widths[l + 1] for l in range(L))
             if bwd else 0) + 3
    pt = d_in + sum(2 * S * widths[l + 1] for l in range(L - 1)) + S * D_OUT
    pt += (S * maxw if bwd else 0) + 3
    pt += pt & 1
    return total + n_acc + points * pt


def fits_kernel(widths: Sequence[int], d_in: int,
                dtype: torch.dtype = torch.float64) -> bool:
    """True when the CUDA kernels take this MLP: d_in 2 or 3, a (u, v, p)
    head, at most MAX_LAYERS layers of at most MAX_WIDTH, and one point's
    backward working set in one block's shared memory."""
    widths = [int(w) for w in widths]
    L = len(widths) - 1
    if d_in not in (2, 3) or widths[0] != d_in or widths[-1] != D_OUT:
        return False
    if not 1 <= L <= MAX_LAYERS or max(widths[1:]) > MAX_WIDTH:
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    return smem_elems(widths, d_in, 1, True) * itemsize <= SMEM_LIMIT


def _check_kernel_args(params, x) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ns_residual kernels take float32/float64, not {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("ns_residual kernels take a contiguous (n, d_in) batch")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"batch of {x.shape[0]} points exceeds the int32 range")
    widths = _widths(params)
    if not fits_kernel(widths, int(x.shape[1]), x.dtype):
        raise ValueError(
            f"ns_residual kernels do not take widths {widths}: at most "
            f"{MAX_LAYERS} layers of at most {MAX_WIDTH}, and one point's "
            f"working set within {SMEM_LIMIT} bytes of shared memory")
    for p in params:
        for t in (p["kernel"], p["bias"]):
            if t.device != x.device or t.dtype != x.dtype:
                raise ValueError("params must share the batch's device and dtype")
            if not t.is_contiguous():
                raise ValueError("params must be contiguous")


def _flat(params) -> List[torch.Tensor]:
    return [t for p in params for t in (p["kernel"], p["bias"])]


def _unflat(flat) -> List[dict]:
    return [{"kernel": flat[i], "bias": flat[i + 1]}
            for i in range(0, len(flat), 2)]


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _plan(lib, bwd: bool, x: torch.Tensor, widths, n_eff: int):
    key = (x.device.index, bwd, x.dtype, tuple(widths), n_eff)
    plan = _PLANS.get(key)
    if plan is None:
        L = len(widths) - 1
        w_arr = (ctypes.c_int * (L + 1))(*widths)
        outs = [ctypes.c_int(0) for _ in range(4)]
        rc = lib.ns_residual_plan(
            int(bwd), int(x.dtype == torch.float64), ctypes.addressof(w_arr),
            L, int(x.shape[1]), n_eff, *[ctypes.addressof(o) for o in outs])
        if rc != 0:
            raise RuntimeError(f"ns_residual_plan failed with code {rc}")
        plan = tuple(o.value for o in outs)  # (P, G, smem bytes, n_acc)
        _PLANS[key] = plan
    return plan


def _launch(bwd: bool, params, x, physics, norm, gbar, n_valid, n_mean,
            with_loss: bool) -> torch.Tensor:
    from tpinn_torch.kernels import build

    if x.device.type != "cuda":
        raise ValueError("ns_residual kernels run on CUDA tensors only")
    _check_layout(params, x, physics)
    _check_kernel_args(params, x)
    lib = build.library()
    widths = _widths(params)
    L = len(widths) - 1
    n = int(x.shape[0])
    n_eff = min(n, n if n_valid is None else int(n_valid))
    n_mean = n if n_mean is None else int(n_mean)
    with torch.cuda.device(x.device):
        P, G, smem, n_acc = _plan(lib, bwd, x, widths, n_eff)
        part = torch.empty(G * n_acc, dtype=x.dtype, device=x.device)
        out = torch.empty(n_acc + 1, dtype=x.dtype, device=x.device)
        w_ptrs = (ctypes.c_void_p * L)(*[p["kernel"].data_ptr() for p in params])
        b_ptrs = (ctypes.c_void_p * L)(*[p["bias"].data_ptr() for p in params])
        w_arr = (ctypes.c_int * (L + 1))(*widths)
        phys = (ctypes.c_double * 7)(*_phys_items(physics, norm))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        f64 = x.dtype == torch.float64
        common = (x.data_ptr(), ctypes.addressof(w_ptrs),
                  ctypes.addressof(b_ptrs), ctypes.addressof(w_arr), L,
                  int(x.shape[1]), n_eff, ctypes.addressof(phys))
        if bwd:
            if gbar.device != x.device or gbar.dtype != x.dtype or \
                    gbar.shape != (3,) or not gbar.is_contiguous():
                raise ValueError("gbar must be a contiguous (3,) tensor on "
                                 "the batch's device and dtype")
            fn = lib.ns_residual_bwd_f64 if f64 else lib.ns_residual_bwd_f32
            rc = fn(*common, gbar.data_ptr(), 2.0 / n_mean, float(n_mean),
                    int(with_loss), P, G, smem, part.data_ptr(),
                    out.data_ptr(), stream)
        else:
            fn = lib.ns_residual_fwd_f64 if f64 else lib.ns_residual_fwd_f32
            rc = fn(*common, float(n_mean), P, G, smem, part.data_ptr(),
                    out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ns_residual_{'bwd' if bwd else 'fwd'} launch "
                           f"failed: cudaError {rc}")
    LAUNCHES["ns_residual_bwd" if bwd else "ns_residual_fwd"] += 1
    return out


def ns_residual_bwd(params, x, physics, norm, gbar: torch.Tensor,
                    n_valid: Optional[int] = None,
                    n_mean: Optional[int] = None, with_loss: bool = False):
    """Kernel 1 on a CUDA batch: (dparams, mses, loss) where dparams are the
    parameter cotangents of the (3,) MSE cotangents ``gbar`` and loss is
    ``gbar · mses`` when ``with_loss`` (else None)."""
    out = _launch(True, params, x, physics, norm, gbar, n_valid, n_mean,
                  with_loss)
    dparams, off = [], 0
    for p in params:
        w_in, w_out = p["kernel"].shape
        dparams.append({
            "kernel": out[off:off + w_in * w_out].view(w_in, w_out),
            "bias": out[off + w_in * w_out:off + (w_in + 1) * w_out],
        })
        off += (w_in + 1) * w_out
    return dparams, out[off:off + 3], (out[off + 3] if with_loss else None)


def ns_residual_fwd(params, x, physics, norm, n_valid: Optional[int] = None,
                    n_mean: Optional[int] = None) -> torch.Tensor:
    """Kernel 2 on a CUDA batch: the (3,) MSEs (mass, mom-u, mom-v)."""
    out = _launch(False, params, x, physics, norm, None, n_valid, n_mean,
                  False)
    return out[:3]


class _Spec:
    """Non-tensor arguments of the autograd Functions."""

    def __init__(self, physics, norm, n_valid, n_mean, weights=None):
        self.physics, self.norm = physics, norm
        self.n_valid, self.n_mean = n_valid, n_mean
        self.weights = weights


class _WeightedObjective(torch.autograd.Function):
    """Forward launches kernel 1 with the loss weights as cotangents and keeps
    its dparams; backward scales them by the incoming loss cotangent.  The
    MSEs are log channels: non-differentiable, their cotangent is dropped."""

    @staticmethod
    def forward(ctx, x, spec, *flat):
        dparams, mses, loss = ns_residual_bwd(
            _unflat(flat), x, spec.physics, spec.norm, spec.weights,
            spec.n_valid, spec.n_mean, with_loss=True)
        ctx.dflat = _flat(dparams)
        ctx.mark_non_differentiable(mses)
        return loss, mses

    @staticmethod
    def backward(ctx, g_loss, g_mses):
        return (None, None, *[g_loss * d for d in ctx.dflat])


class _ResidualMSE(torch.autograd.Function):
    """Forward launches kernel 2; backward launches kernel 1 with the
    incoming MSE cotangents."""

    @staticmethod
    def forward(ctx, x, spec, *flat):
        ctx.spec = spec
        ctx.save_for_backward(x, *flat)
        return ns_residual_fwd(_unflat(flat), x, spec.physics, spec.norm,
                               spec.n_valid, spec.n_mean)

    @staticmethod
    def backward(ctx, g_mses):
        x, *flat = ctx.saved_tensors
        spec = ctx.spec
        dparams, _, _ = ns_residual_bwd(
            _unflat(flat), x, spec.physics, spec.norm, g_mses.contiguous(),
            spec.n_valid, spec.n_mean)
        return (None, None, *_flat(dparams))


def _route(x: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"ns_residual: no path for device {x.device}")


def ns_residual_weighted_obj(params, x, physics, norm, weights,
                             n_valid: Optional[int] = None,
                             n_mean: Optional[int] = None):
    """(weighted_loss, (mse_mass, mse_u, mse_v)) in one kernel launch.

    ``weighted_loss = w · mses`` is differentiable w.r.t. ``params``; the
    MSEs are for logging only (no gradient).  ``n_valid`` masks rows at and
    beyond it; ``n_mean`` is the mean denominator (both default to len(x))."""
    if not _route(x):
        return ns_residual_weighted_obj_plain(params, x, physics, norm,
                                              weights, n_valid, n_mean)
    _check_layout(params, x, physics)
    if not torch.is_tensor(weights):
        weights = torch.tensor([float(w) for w in weights], dtype=x.dtype,
                               device=x.device)
    spec = _Spec(physics, norm, n_valid, n_mean, weights)
    return _WeightedObjective.apply(x, spec, *_flat(params))


def ns_residual_mse(params, x, physics, norm, n_valid: Optional[int] = None,
                    n_mean: Optional[int] = None) -> torch.Tensor:
    """(mse_mass, mse_u, mse_v), differentiable w.r.t. ``params`` (kernel 2
    forward, kernel 1 backward on CUDA).  No gradient w.r.t. ``x``."""
    if not _route(x):
        return ns_residual_mse_plain(params, x, physics, norm, n_valid, n_mean)
    _check_layout(params, x, physics)
    spec = _Spec(physics, norm, n_valid, n_mean)
    return _ResidualMSE.apply(x, spec, *_flat(params))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def ns_residual_mse_plain(params, x, physics, norm,
                          n_valid: Optional[int] = None,
                          n_mean: Optional[int] = None) -> torch.Tensor:
    """Plain twin of ``ns_residual_mse``: closed-form Taylor streams, the
    pipeline's residual rows, masked squared sums ÷ n_mean; autograd gives
    the parameter gradients."""
    from tpinn_torch.pipeline import _mass_rows, _momentum_rows

    widths = _check_layout(params, x, physics)
    n = int(x.shape[0])
    n_eff = min(n, n if n_valid is None else int(n_valid))
    n_mean = n if n_mean is None else int(n_mean)
    cols = (1, 2) if widths[0] == 3 else (0, 1)
    value, jac, hdiag = mlp_taylor_batched(params, x[:n_eff], widths[0])
    rows = (_mass_rows(jac, cols),
            _momentum_rows(value, jac, hdiag, cols, 0, physics, norm),
            _momentum_rows(value, jac, hdiag, cols, 1, physics, norm))
    return torch.stack([torch.sum(r * r) for r in rows]) / n_mean


def ns_residual_weighted_obj_plain(params, x, physics, norm, weights,
                                   n_valid: Optional[int] = None,
                                   n_mean: Optional[int] = None):
    """Plain twin of ``ns_residual_weighted_obj``."""
    mses = ns_residual_mse_plain(params, x, physics, norm, n_valid, n_mean)
    w = [float(v) for v in (weights.tolist() if torch.is_tensor(weights)
                            else weights)]
    loss = w[0] * mses[0] + w[1] * mses[1] + w[2] * mses[2]
    return loss, mses.detach()
