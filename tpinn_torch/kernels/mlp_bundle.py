"""Fused PDE-residual kernels: torch side.

Two CUDA kernels (csrc/ns_residual.cu) replace the NS-residual Pallas kernels
of the JAX package:

* ``ns_residual_bwd`` — the one-pass backward: Taylor streams, residuals,
  cotangents, every dW/db and the three MSEs in one launch (the last block
  sums the block partials in a fixed order).  ``ns_residual_weighted_obj``
  calls it with the loss weights as cotangents: weighted loss, log MSEs and
  parameter gradients from one pass.
* ``ns_residual_fwd`` — the forward: the three MSEs only.  It is the forward
  of ``ns_residual_mse``, whose backward is ``ns_residual_bwd``.

Two more (csrc/poisson_residual.cu) replace the Poisson-residual ones, for a
scalar MLP u(x, y) and r = (Δu + f)/normalization:

* ``poisson_residual_bwd`` — the one-pass backward: Σ r² and every dW/db of
  the MSE cotangent in one launch; ``poisson_residual_weighted_obj`` calls
  it with the loss weight as cotangent.
* ``poisson_residual_fwd`` — the forward: Σ r² only, the forward of
  ``poisson_residual_mse``, whose backward is ``poisson_residual_bwd``.

One more (csrc/taylor_bundle.cu) replaces the JAX package's Taylor-bundle
kernel (``_kernel``, launched by its ``mlp_taylor_bundle``):

* ``mlp_taylor_bundle`` — per point the value, Jacobian and Hessian
  diagonal of a tanh MLP, forward only: as in the JAX package, reverse mode
  through it raises.

Beside each public function sits its plain PyTorch version (``*_plain``),
built on :func:`tpinn_torch.operators.mlp_taylor_batched` and autograd.  A
tensor on the CPU takes the plain version; a CUDA tensor launches the kernel
or raises.  ``LAUNCHES`` counts the launches of each kernel (one per wrapper
call that launches it), the L-BFGS direction's (``lbfgs_direction.py``)
too.  A call of kernels 1-4 checks its tensors, looks up
the plan of its shape (``residual_plan``, computed once: tile, grid, shared
bytes), makes one
allocation for the block partials and the outputs, and launches once;
``tile_layout`` and ``plan_points`` mirror the plan on the host, for the
fit checks and the tests.  A kernel-5 call does the same with one
allocation for value, jac and hdiag, and takes the autograd Function only
when a gradient could flow; ``bundle_layout`` and ``bundle_plan`` mirror its
plan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tpinn_torch.operators import mlp_taylor_batched

MAX_LAYERS = 8  # Dense layers, head included
MAX_WIDTH = 64  # any layer's output width
SMEM_LIMIT = 227 * 1024  # bytes of shared memory a block may use
D_OUT = 3
N_H = 2
SKEW = 4  # row stride of a stream matrix: padded width + SKEW
TILE_POINTS = (32, 16, 8, 4, 2, 1)  # candidate points per tile
SMS = 132  # streaming multiprocessors of an H100 SXM
ITEMSIZE = {torch.float32: 4, torch.float64: 8}

LAUNCHES: Dict[str, int] = {"ns_residual_bwd": 0, "ns_residual_fwd": 0,
                             "poisson_residual_bwd": 0,
                             "poisson_residual_fwd": 0, "taylor_bundle": 0,
                             "lbfgs_direction": 0}
_PLANS: Dict[tuple, object] = {}
_TICKETS: Dict[tuple, torch.Tensor] = {}


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


def _pad8(v: int) -> int:
    return (v + 7) & ~7


def _align4(v: int) -> int:
    return (v + 3) & ~3


def tile_layout(widths: Sequence[int], d_in: int, points: int, bwd: bool,
                n_sq: int = 3, x_extra: int = 0, acc_smem: bool = True) -> dict:
    """One block's shared-memory layout in elements (mirrors ``Layout::build``
    in csrc/taylor_mlp.cuh): ``wp`` the padded widths (d_in, then each
    output width rounded up to 8), ``ld`` the row strides (wp + SKEW),
    ``R`` the stream rows of a tile (S·points rounded up to 8), ``total``
    the elements and ``n_acc`` the accumulators (dW/db in the output's
    order, then the squared sums), held in shared memory when ``acc_smem``.
    ``n_sq`` is the number of squared-residual sums (3 for Navier–Stokes,
    1 for Poisson) and ``x_extra`` the extra input columns per point (the
    Poisson forcing)."""
    S = 1 + d_in + N_H
    L = len(widths) - 1
    R = _pad8(S * points)
    wp = [d_in] + [_pad8(int(w)) for w in widths[1:]]
    ld = [d_in] + [w + SKEW for w in wp[1:]]
    off = sum(wp[l] * ld[l + 1] + wp[l + 1] for l in range(L))
    n_acc = n_sq
    if bwd:
        n_acc += sum((widths[l] + 1) * widths[l + 1] for l in range(L))
    if acc_smem:
        off += _align4(n_acc)
    off += 2 * _align4(points * (d_in + x_extra))
    off += sum(2 * R * ld[l + 1] for l in range(L - 1)) + R * ld[L]
    if bwd:
        off += 2 * R * max(ld[1:])
    off += _align4(points * n_sq)
    return {"P": points, "R": R, "wp": wp, "ld": ld, "total": off,
            "n_acc": n_acc}


def smem_elems(widths: Sequence[int], d_in: int, points: int, bwd: bool,
               n_sq: int = 3, x_extra: int = 0, acc_smem: bool = True) -> int:
    """Shared-memory elements of one block (``tile_layout``'s total)."""
    return tile_layout(widths, d_in, points, bwd, n_sq, x_extra,
                       acc_smem)["total"]


def _tile_fits(widths, d_in, n_sq, x_extra, itemsize, points,
               acc_smem) -> bool:
    return smem_elems(widths, d_in, points, True, n_sq, x_extra,
                      acc_smem) * itemsize <= SMEM_LIMIT


def plan_points(widths: Sequence[int], d_in: int, n_sq: int, x_extra: int,
                itemsize: int, n_eff: int, sms: int = SMS) -> int:
    """Points per tile for one call shape (mirrors ``plan_points`` in
    csrc/taylor_mlp.cuh): among the candidates whose backward block fits
    SMEM_LIMIT (with the accumulators in the partials if need be), the
    largest whose tile count reaches ``sms`` or that is at most 8; 0 when
    none fits.  The accumulators stay in shared memory when
    ``_tile_fits(..., P, True)``."""
    for P in TILE_POINTS:
        if _tile_fits(widths, d_in, n_sq, x_extra, itemsize, P, False) and \
                (P <= 8 or -(-n_eff // P) >= sms):
            return P
    return 0


def _fits(widths: Sequence[int], d_in: int, d_out: int, n_sq: int,
          x_extra: int, dtype: torch.dtype) -> bool:
    widths = [int(w) for w in widths]
    L = len(widths) - 1
    if widths[0] != d_in or widths[-1] != d_out:
        return False
    if not 1 <= L <= MAX_LAYERS or max(widths[1:]) > MAX_WIDTH:
        return False
    return _tile_fits(widths, d_in, n_sq, x_extra, ITEMSIZE[dtype], 1, False)


def fits_kernel(widths: Sequence[int], d_in: int,
                dtype: torch.dtype = torch.float64) -> bool:
    """True when the CUDA NS kernels take this MLP: d_in 2 or 3, a (u, v, p)
    head, at most MAX_LAYERS layers of at most MAX_WIDTH, and a one-point
    tile's backward block within SMEM_LIMIT bytes of shared memory."""
    return d_in in (2, 3) and _fits(widths, d_in, D_OUT, 3, 0, dtype)


def fits_poisson_kernel(widths: Sequence[int],
                        dtype: torch.dtype = torch.float64) -> bool:
    """True when the CUDA Poisson kernels take this MLP: inputs (x, y), a
    scalar head, and the same layer and shared-memory limits."""
    return _fits(widths, 2, 1, 1, 1, dtype)


def _flat(params) -> List[torch.Tensor]:
    return [t for p in params for t in (p["kernel"], p["bias"])]


def _unflat(flat) -> List[dict]:
    return [{"kernel": flat[i], "bias": flat[i + 1]}
            for i in range(0, len(flat), 2)]


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


class _Plan:
    """What one call shape needs beyond its tensors, computed once: the
    entry point, points per tile, grid, shared bytes, accumulator count, the
    widths array, the mean's constants, and how the call's one buffer
    splits: the partials, each dW/db (``shapes``: dW's), the MSEs, the
    loss."""

    __slots__ = ("fn", "P", "G", "smem", "n_acc", "L", "w_arr", "n_mean",
                 "two_over_n", "sizes", "shapes")


def residual_plan(kind: str, bwd: bool, x: torch.Tensor, widths: List[int],
                  n_eff: int, n_mean: int) -> _Plan:
    """The cached plan of a call shape of kernels 1-4 (``kind``
    "ns_residual" or "poisson_residual", backward or forward, on the
    batch's device and dtype; ``P`` its points per tile, ``G`` its grid);
    raises for a dtype or net that the kernels do not take (checked once
    per shape)."""
    key = (kind, x.device.index, x.dtype, tuple(widths), n_eff, n_mean, bwd)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    from tpinn_torch.kernels import build

    if x.dtype not in ITEMSIZE:
        raise TypeError(f"{kind} kernels take float32/float64, not {x.dtype}")
    poisson = kind == "poisson_residual"
    d_in = int(x.shape[1])
    if not (fits_poisson_kernel(widths, x.dtype) if poisson
            else fits_kernel(widths, d_in, x.dtype)):
        raise ValueError(
            f"{kind} kernels do not take widths {widths}: at most "
            f"{MAX_LAYERS} layers of at most {MAX_WIDTH}, and a one-point "
            f"tile within {SMEM_LIMIT} bytes of shared memory")
    lib = build.library(f"{kind}.cu")
    L = len(widths) - 1
    plan = _Plan()
    plan.L = L
    plan.w_arr = (ctypes.c_int * (L + 1))(*widths)
    plan.n_mean = float(n_mean)
    plan.two_over_n = 2.0 / n_mean
    f64 = x.dtype == torch.float64
    outs = [ctypes.c_int(0) for _ in range(4)]
    head = (int(bwd), int(f64), ctypes.addressof(plan.w_arr), L)
    shape = (n_eff,) if poisson else (d_in, n_eff)
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"{kind}_plan")(
            *head, *shape, *[ctypes.addressof(o) for o in outs])
    if rc != 0:
        raise RuntimeError(f"{kind}_plan failed with code {rc}")
    plan.P, plan.G, plan.smem, plan.n_acc = (o.value for o in outs)
    plan.fn = getattr(lib, f"{kind}_{'bwd' if bwd else 'fwd'}_"
                           f"{'f64' if f64 else 'f32'}")
    plan.shapes = [(a, b) for a, b in zip(widths[:-1], widths[1:])] \
        if bwd else []
    plan.sizes = [plan.G * plan.n_acc] + [
        k for a, b in plan.shapes for k in (a * b, b)] + [
        plan.n_acc - sum(a * b + b for a, b in plan.shapes), 1]
    _PLANS[key] = plan
    return plan


def _check_tensors(params, x: torch.Tensor, kind: str) -> None:
    """Per call: the batch is a contiguous (n, d_in) tensor within the int32
    range, and every parameter is contiguous on its device and dtype."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{kind} kernels take a contiguous (n, d_in) batch")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"batch of {x.shape[0]} points exceeds the int32 range")
    dev, dt = x.device, x.dtype
    for p in params:
        for t in (p["kernel"], p["bias"]):
            if t.device != dev or t.dtype != dt:
                raise ValueError("params must share the batch's device and dtype")
            if not t.is_contiguous():
                raise ValueError("params must be contiguous")


def _check_cotangent(gbar, x: torch.Tensor, n: int) -> None:
    if gbar.device != x.device or gbar.dtype != x.dtype or \
            gbar.shape != (n,) or not gbar.is_contiguous():
        raise ValueError(f"gbar must be a contiguous ({n},) tensor on the "
                         "batch's device and dtype")


def _ticket(x: torch.Tensor, stream: int) -> torch.Tensor:
    """The launches' ticket on one stream: an unsigned that each launch's
    last block resets to zero."""
    key = (x.device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=x.device)
    return t


# PyTorch's current stream of a device as a raw handle; the public
# torch.cuda.current_stream() builds a Stream object per call, a third of
# a small call's host time
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def raw_stream(index: int) -> int:
    """PyTorch's current stream of CUDA device ``index``, as the raw handle
    a kernel's C interface takes (kernels 1-5 and the L-BFGS direction)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def _call(x: torch.Tensor, fn, *args) -> int:
    """Call a launcher on the batch's device with PyTorch's current stream
    appended."""
    index = x.device.index
    stream = raw_stream(index)
    if index == torch.cuda.current_device():
        return fn(*args, _ticket(x, stream).data_ptr(), stream)
    with torch.cuda.device(index):
        return fn(*args, _ticket(x, stream).data_ptr(), stream)


def _launch(bwd: bool, params, x, physics, norm, gbar, n_valid, n_mean,
            with_loss: bool):
    """Kernel 1 (bwd) or 2 on a CUDA batch: (dparams, mses, loss slot) as
    views of one buffer; the one place where a kernel call checks the
    layout."""
    if x.device.type != "cuda":
        raise ValueError("ns_residual kernels run on CUDA tensors only")
    widths = _check_layout(params, x, physics)
    n = int(x.shape[0])
    n_eff = n if n_valid is None else min(n, int(n_valid))
    if n_eff <= 0:
        return _empty_sums(bwd, params, x)
    plan = residual_plan("ns_residual", bwd, x, widths, n_eff,
                         n if n_mean is None else int(n_mean))
    _check_tensors(params, x, "ns_residual")
    G, n_acc, L = plan.G, plan.n_acc, plan.L
    buf = torch.empty(G * n_acc + n_acc + 1, dtype=x.dtype, device=x.device)
    w_ptrs = (ctypes.c_void_p * L)(*[p["kernel"].data_ptr() for p in params])
    b_ptrs = (ctypes.c_void_p * L)(*[p["bias"].data_ptr() for p in params])
    phys = (ctypes.c_double * 7)(*_phys_items(physics, norm))
    common = (x.data_ptr(), w_ptrs, b_ptrs, plan.w_arr, L, int(x.shape[1]),
              n_eff, phys)
    tail = (plan.P, G, plan.smem, buf.data_ptr(),
            buf.data_ptr() + G * n_acc * buf.element_size())
    if bwd:
        _check_cotangent(gbar, x, 3)
        rc = _call(x, plan.fn, *common, gbar.data_ptr(), plan.two_over_n,
                   plan.n_mean, int(with_loss), *tail)
    else:
        rc = _call(x, plan.fn, *common, plan.n_mean, *tail)
    if rc != 0:
        raise RuntimeError(f"ns_residual_{'bwd' if bwd else 'fwd'} launch "
                           f"failed: cudaError {rc}")
    LAUNCHES["ns_residual_bwd" if bwd else "ns_residual_fwd"] += 1
    return _unpack(plan, buf)


def _empty_sums(bwd: bool, params, x: torch.Tensor):
    """What a call of kernel 1 or 2 over no valid row returns, without a
    launch: zero dparams (backward), zero MSEs and a zero loss slot.  A
    shard of a point mesh that holds padding alone makes such a call."""
    dparams = [{k: torch.zeros_like(p[k]) for k in ("kernel", "bias")}
               for p in params] if bwd else []
    sums = torch.zeros(4, dtype=x.dtype, device=x.device)
    return dparams, sums[:3], sums[3:]


def _unpack(plan: _Plan, buf: torch.Tensor):
    """(dparams, mses, loss) as views of a call's buffer, by one split:
    dparams per layer {kernel, bias} (empty for a forward call), the
    squared-sum MSEs and the (1,) loss slot."""
    parts = buf.split(plan.sizes)
    dparams = [{"kernel": parts[1 + 2 * i].view(shape), "bias": parts[2 + 2 * i]}
               for i, shape in enumerate(plan.shapes)]
    return dparams, parts[-2], parts[-1]


def ns_residual_bwd(params, x, physics, norm, gbar: torch.Tensor,
                    n_valid: Optional[int] = None,
                    n_mean: Optional[int] = None, with_loss: bool = False):
    """Kernel 1 on a CUDA batch: (dparams, mses, loss) where dparams are the
    parameter cotangents of the (3,) MSE cotangents ``gbar`` and loss is
    ``gbar · mses`` when ``with_loss`` (else None)."""
    dparams, mses, loss = _launch(True, params, x, physics, norm, gbar,
                                  n_valid, n_mean, with_loss)
    return dparams, mses, (loss.view(()) if with_loss else None)


def ns_residual_fwd(params, x, physics, norm, n_valid: Optional[int] = None,
                    n_mean: Optional[int] = None) -> torch.Tensor:
    """Kernel 2 on a CUDA batch: the (3,) MSEs (mass, mom-u, mom-v)."""
    return _launch(False, params, x, physics, norm, None, n_valid, n_mean,
                   False)[1]


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


def _route(x: torch.Tensor, kind: str = "ns_residual") -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{kind}: no path for device {x.device}")


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


# ---------------------------------------------------------------------------
# Poisson: r = (∂²u/∂x² + ∂²u/∂y² + f) / normalization for a scalar u(x, y)
# ---------------------------------------------------------------------------


def _check_poisson_layout(params, x, f) -> List[int]:
    widths = _widths(params)
    if x.dim() != 2 or int(x.shape[1]) != 2 or widths[0] != 2:
        raise ValueError(f"poisson_residual: widths {widths} on a batch of "
                         f"shape {tuple(x.shape)}; expected (n, 2) inputs (x, y)")
    if widths[-1] != 1:
        raise ValueError(f"poisson_residual: widths {widths} do not end in a "
                         "scalar head")
    if f.numel() != x.shape[0]:
        raise ValueError(f"poisson_residual: {f.numel()} forcing values for "
                         f"{x.shape[0]} points")
    return widths


def _poisson_launch(bwd: bool, params, x, f, normalization, gbar, n_valid,
                    n_mean, with_loss: bool):
    """Kernel 3 (bwd) or 4 on a CUDA batch: (dparams, (1,) mse, loss slot)
    as views of one buffer; the one place where a kernel call checks the
    layout."""
    if x.device.type != "cuda":
        raise ValueError("poisson_residual kernels run on CUDA tensors only")
    widths = _check_poisson_layout(params, x, f)
    n = int(x.shape[0])
    n_eff = n if n_valid is None else min(n, int(n_valid))
    plan = residual_plan("poisson_residual", bwd, x, widths, n_eff,
                         n if n_mean is None else int(n_mean))
    _check_tensors(params, x, "poisson_residual")
    if f.device != x.device or f.dtype != x.dtype or f.dim() != 1 or \
            not f.is_contiguous():
        raise ValueError("f must be a contiguous (n,) tensor on the batch's "
                         "device and dtype")
    G, n_acc, L = plan.G, plan.n_acc, plan.L
    buf = torch.empty(G * n_acc + n_acc + 1, dtype=x.dtype, device=x.device)
    w_ptrs = (ctypes.c_void_p * L)(*[p["kernel"].data_ptr() for p in params])
    b_ptrs = (ctypes.c_void_p * L)(*[p["bias"].data_ptr() for p in params])
    common = (x.data_ptr(), f.data_ptr(), w_ptrs, b_ptrs, plan.w_arr, L,
              n_eff, 1.0 / float(normalization))
    tail = (plan.P, G, plan.smem, buf.data_ptr(),
            buf.data_ptr() + G * n_acc * buf.element_size())
    if bwd:
        _check_cotangent(gbar, x, 1)
        rc = _call(x, plan.fn, *common, gbar.data_ptr(), plan.two_over_n,
                   plan.n_mean, int(with_loss), *tail)
    else:
        rc = _call(x, plan.fn, *common, plan.n_mean, *tail)
    if rc != 0:
        raise RuntimeError(f"poisson_residual_{'bwd' if bwd else 'fwd'} "
                           f"launch failed: cudaError {rc}")
    LAUNCHES["poisson_residual_bwd" if bwd else "poisson_residual_fwd"] += 1
    return _unpack(plan, buf)


def poisson_residual_bwd(params, x, f, gbar: torch.Tensor,
                         normalization: float = 1.0,
                         n_valid: Optional[int] = None,
                         n_mean: Optional[int] = None,
                         with_loss: bool = False):
    """Kernel 3 on a CUDA batch: (dparams, mse, loss) where dparams are the
    parameter cotangents of the (1,) MSE cotangent ``gbar`` and loss is
    ``gbar · mse`` when ``with_loss`` (else None).  The head bias gradient
    is exactly zero (Δu does not depend on it)."""
    dparams, mse, loss = _poisson_launch(True, params, x, f, normalization,
                                         gbar, n_valid, n_mean, with_loss)
    return dparams, mse.view(()), (loss.view(()) if with_loss else None)


def poisson_residual_fwd(params, x, f, normalization: float = 1.0,
                         n_valid: Optional[int] = None,
                         n_mean: Optional[int] = None) -> torch.Tensor:
    """Kernel 4 on a CUDA batch: the MSE (a 0-dim tensor)."""
    return _poisson_launch(False, params, x, f, normalization, None, n_valid,
                           n_mean, False)[1].view(())


class _PoissonSpec:
    """Non-tensor arguments of the Poisson autograd Functions."""

    def __init__(self, normalization, n_valid, n_mean, weight=None):
        self.normalization = float(normalization)
        self.n_valid, self.n_mean = n_valid, n_mean
        self.weight = weight


class _PoissonWeightedObjective(torch.autograd.Function):
    """Forward launches kernel 3 with the loss weight as cotangent and keeps
    its dparams; backward scales them by the incoming loss cotangent.  The
    MSE is a log channel: non-differentiable, its cotangent is dropped."""

    @staticmethod
    def forward(ctx, x, f, spec, *flat):
        dparams, mse, loss = poisson_residual_bwd(
            _unflat(flat), x, f, spec.weight, spec.normalization,
            spec.n_valid, spec.n_mean, with_loss=True)
        ctx.dflat = _flat(dparams)
        ctx.mark_non_differentiable(mse)
        return loss, mse

    @staticmethod
    def backward(ctx, g_loss, g_mse):
        return (None, None, None, *[g_loss * d for d in ctx.dflat])


class _PoissonResidualMSE(torch.autograd.Function):
    """Forward launches kernel 4; backward launches kernel 3 with the
    incoming MSE cotangent.  No gradient in x or f."""

    @staticmethod
    def forward(ctx, x, f, spec, *flat):
        ctx.spec = spec
        ctx.save_for_backward(x, f, *flat)
        return poisson_residual_fwd(_unflat(flat), x, f, spec.normalization,
                                    spec.n_valid, spec.n_mean)

    @staticmethod
    def backward(ctx, g_mse):
        x, f, *flat = ctx.saved_tensors
        spec = ctx.spec
        dparams, _, _ = poisson_residual_bwd(
            _unflat(flat), x, f, g_mse.reshape(1).contiguous(),
            spec.normalization, spec.n_valid, spec.n_mean)
        return (None, None, None, *_flat(dparams))


def poisson_residual_weighted_obj(params, x, f, weight,
                                  normalization: float = 1.0,
                                  n_valid: Optional[int] = None,
                                  n_mean: Optional[int] = None):
    """(weight·mse, mse) in one kernel launch, mse = mean over the first
    ``n_valid`` rows (÷ ``n_mean``) of ((Δu + f)/normalization)².

    The loss is differentiable w.r.t. ``params``; the MSE is for logging
    only (no gradient).  ``weight`` is a float or a (1,) tensor on the
    batch's device (a caller that evaluates every step keeps one, so no
    host-to-device copy is made per call)."""
    f = f.reshape(-1)
    if not _route(x, "poisson_residual"):
        w = float(weight.reshape(-1)[0]) if torch.is_tensor(weight) else weight
        return poisson_residual_weighted_obj_plain(
            params, x, f, w, normalization, n_valid, n_mean)
    if not torch.is_tensor(weight):
        weight = torch.tensor([float(weight)], dtype=x.dtype, device=x.device)
    spec = _PoissonSpec(normalization, n_valid, n_mean, weight.reshape(1))
    return _PoissonWeightedObjective.apply(x, f.contiguous(), spec,
                                           *_flat(params))


def poisson_residual_mse(params, x, f, normalization: float = 1.0,
                         n_valid: Optional[int] = None,
                         n_mean: Optional[int] = None) -> torch.Tensor:
    """mean(((Δu + f)/normalization)²) of a scalar tanh MLP, differentiable
    w.r.t. ``params`` (kernel 4 forward, kernel 3 backward on CUDA).  No
    gradient w.r.t. ``x`` or ``f``."""
    f = f.reshape(-1)
    if not _route(x, "poisson_residual"):
        return poisson_residual_mse_plain(params, x, f, normalization,
                                          n_valid, n_mean)
    spec = _PoissonSpec(normalization, n_valid, n_mean)
    return _PoissonResidualMSE.apply(x, f.contiguous(), spec, *_flat(params))


def poisson_residual_mse_plain(params, x, f, normalization: float = 1.0,
                               n_valid: Optional[int] = None,
                               n_mean: Optional[int] = None) -> torch.Tensor:
    """Plain twin of ``poisson_residual_mse``: the closed-form Hessian
    diagonal of the scalar head, r = (−Δu − f)/normalization on the first
    ``n_valid`` rows, Σ r² ÷ ``n_mean``; autograd gives the gradients."""
    f = f.reshape(-1)
    _check_poisson_layout(params, x, f)
    n = int(x.shape[0])
    n_eff = min(n, n if n_valid is None else int(n_valid))
    n_mean = n if n_mean is None else int(n_mean)
    _, _, hdiag = mlp_taylor_batched(params, x[:n_eff], 2)
    r = (-(hdiag[:, 0, 0] + hdiag[:, 0, 1]) - f[:n_eff]) / normalization
    return torch.sum(r * r) / n_mean


def poisson_residual_weighted_obj_plain(params, x, f, weight: float,
                                        normalization: float = 1.0,
                                        n_valid: Optional[int] = None,
                                        n_mean: Optional[int] = None):
    """Plain twin of ``poisson_residual_weighted_obj``."""
    mse = poisson_residual_mse_plain(params, x, f, normalization, n_valid,
                                     n_mean)
    return float(weight) * mse, mse.detach()


# ---------------------------------------------------------------------------
# Kernel 5: the Taylor bundle (value, Jacobian, Hessian diagonal) of a tanh
# MLP at every point; no reduction, no reverse mode
# ---------------------------------------------------------------------------

TWO_BLOCK_SMEM = 113 * 1024  # bytes of a block that leaves room for two per SM
BUNDLE_TILE_POINTS = (32, 16, 8)  # candidate points per kernel-5 tile


def bundle_layout(widths: Sequence[int], d_in: int, dim: int, points: int,
                  streamed: bool) -> dict:
    """One kernel-5 block's shared-memory layout in elements (mirrors
    ``BundleLayout::build`` in csrc/taylor_bundle.cu): the padded weights
    (all resident, or W_0 resident and two slots for the larger W_l of
    l >= 1 when ``streamed``), the biases, two input buffers of
    ``points``·d_in and two stream buffers of S·points rows (S = 1 + 2·dim)
    of the largest row stride."""
    L = len(widths) - 1
    wp = [d_in] + [_pad8(int(w)) for w in widths[1:]]
    ld = [d_in] + [w + SKEW for w in wp[1:]]
    sizes = [wp[l] * ld[l + 1] for l in range(L)]
    resident = sizes[:1] if streamed else sizes
    slot = max(sizes[1:], default=0) if streamed else 0
    total = (sum(resident) + sum(wp[1:]) + 2 * slot
             + 2 * _align4(points * d_in)
             + 2 * (1 + 2 * dim) * points * max(ld[1:]))
    return {"wp": wp, "ld": ld, "slot": slot, "total": total}


@functools.lru_cache(maxsize=None)
def bundle_plan(widths: Tuple[int, ...], d_in: int, dim: int,
                itemsize: int) -> Tuple[int, bool, int]:
    """(points per tile, streamed, shared bytes) of kernel 5 for one net
    (mirrors ``bundle_points`` in csrc/taylor_bundle.cu): the largest tile
    whose block leaves room for two blocks per SM with the weights
    resident; else the largest that fits SMEM_LIMIT with the weights
    resident; else the largest with the weights streamed one layer at a
    time.  (0, False, 0) when nothing fits."""
    for budget, streamed in ((TWO_BLOCK_SMEM, False), (SMEM_LIMIT, False),
                             (SMEM_LIMIT, True)):
        for P in BUNDLE_TILE_POINTS:
            nbytes = bundle_layout(widths, d_in, dim, P, streamed)["total"] \
                * itemsize
            if nbytes <= budget:
                return P, streamed, nbytes
    return 0, False, 0


def _check_bundle_shape(params, x, dim) -> Tuple[List[int], int]:
    """(widths, dim) when kernel 5 takes this net and batch, else a
    ValueError naming what it does not take.  Both routes check, so the
    CPU never takes a shape the card would refuse."""
    widths = _widths(params)
    if x.dim() != 2:
        raise ValueError(f"mlp_taylor_bundle: batch of shape "
                         f"{tuple(x.shape)}; expected (n, d_in)")
    d_in = int(x.shape[1])
    dim = d_in if dim is None else int(dim)
    if d_in not in (2, 3) or widths[0] != d_in:
        raise ValueError(f"mlp_taylor_bundle: d_in={d_in} with widths "
                         f"{widths}; kernel 5 takes d_in 2 or 3")
    if not 1 <= dim <= d_in:
        raise ValueError(f"mlp_taylor_bundle: dim={dim} for d_in={d_in}; "
                         "kernel 5 takes 1 <= dim <= d_in")
    L = len(widths) - 1
    if (not 1 <= L <= MAX_LAYERS or max(widths[1:]) > MAX_WIDTH
            or not bundle_plan(tuple(widths), d_in, dim,
                               x.element_size())[0]):
        raise ValueError(
            f"mlp_taylor_bundle: kernel 5 does not take widths {widths}: at "
            f"most {MAX_LAYERS} layers of at most {MAX_WIDTH}, and an "
            f"8-point tile within {SMEM_LIMIT} bytes of shared memory")
    return widths, dim


class _BundlePlan:
    """What one kernel-5 call shape needs beyond its tensors, computed
    once: the entry point, points per tile, grid, shared bytes, whether the
    weights are streamed, the widths array, the call's buffer size and
    where value, jac and hdiag sit in it (shape, strides, offset)."""

    __slots__ = ("fn", "P", "G", "smem", "streamed", "L", "w_arr", "size",
                 "views")


def _bundle_plan(x: torch.Tensor, widths: List[int], dim: int) -> _BundlePlan:
    """The cached plan of a kernel-5 call shape (device, dtype, widths, dim,
    n); raises for a dtype or size the kernel does not take (checked once
    per shape)."""
    n = int(x.shape[0])
    key = ("taylor_bundle", x.device.index, x.dtype, tuple(widths), dim, n)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    from tpinn_torch.kernels import build

    if x.dtype not in ITEMSIZE:
        raise TypeError(f"taylor_bundle kernel takes float32/float64, not "
                        f"{x.dtype}")
    d_in, d_out, L = int(x.shape[1]), widths[-1], len(widths) - 1
    if n * d_out * dim >= 2 ** 31:
        raise ValueError(f"batch of {n} points exceeds the int32 range of "
                         "the outputs")
    lib = build.library("taylor_bundle.cu")
    f64 = x.dtype == torch.float64
    plan = _BundlePlan()
    plan.L = L
    plan.w_arr = (ctypes.c_int * (L + 1))(*widths)
    outs = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(x.device):
        rc = lib.taylor_bundle_plan(int(f64), ctypes.addressof(plan.w_arr), L,
                                    d_in, dim, n,
                                    *[ctypes.addressof(o) for o in outs])
    if rc != 0:
        raise RuntimeError(f"taylor_bundle_plan failed with code {rc}")
    plan.P, plan.G, plan.smem, plan.streamed = (o.value for o in outs)
    plan.fn = lib.taylor_bundle_f64 if f64 else lib.taylor_bundle_f32
    nj = n * d_out * dim
    plan.size = n * d_out + 2 * nj
    plan.views = [((n, d_out), (d_out, 1), 0),
                  ((n, d_out, dim), (d_out * dim, dim, 1), n * d_out),
                  ((n, d_out, dim), (d_out * dim, dim, 1), n * d_out + nj)]
    _PLANS[key] = plan
    return plan


def _bundle_launch(params, x: torch.Tensor, widths: List[int], dim: int):
    """Kernel 5 on a CUDA batch whose shape ``_check_bundle_shape`` took:
    (value, jac, hdiag) as views of one buffer."""
    if x.device.type != "cuda":
        raise ValueError("taylor_bundle kernel runs on CUDA tensors only")
    plan = _bundle_plan(x, widths, dim)
    _check_tensors(params, x, "taylor_bundle")
    buf = torch.empty(plan.size, dtype=x.dtype, device=x.device)
    value, jac, hdiag = (buf.as_strided(*v) for v in plan.views)
    if x.shape[0] == 0:
        return value, jac, hdiag
    L = plan.L
    w_ptrs = (ctypes.c_void_p * L)(*[p["kernel"].data_ptr() for p in params])
    b_ptrs = (ctypes.c_void_p * L)(*[p["bias"].data_ptr() for p in params])
    index = x.device.index
    args = (x.data_ptr(), w_ptrs, b_ptrs, plan.w_arr, L, int(x.shape[1]), dim,
            int(x.shape[0]), plan.P, plan.G, plan.smem, plan.streamed,
            buf.data_ptr(), raw_stream(index))
    if index == torch.cuda.current_device():
        rc = plan.fn(*args)
    else:
        with torch.cuda.device(index):
            rc = plan.fn(*args)
    if rc != 0:
        raise RuntimeError(f"taylor_bundle launch failed: cudaError {rc}")
    LAUNCHES["taylor_bundle"] += 1
    return value, jac, hdiag


_NO_REVERSE = (
    "kernel 5 (mlp_taylor_bundle, selected by TPINN_USE_PALLAS) is forward "
    "only: a gradient, a Jacobian-vector product or a Jacobian through it "
    "(an Adam or BFGS step, the float32 split carries, LM's chunked "
    "Jacobian) is not supported, as in the JAX package, whose Taylor-bundle "
    "kernel has neither a VJP nor a JVP; unset TPINN_USE_PALLAS (or set it "
    "to 0) to differentiate these losses")


class _TaylorBundle(torch.autograd.Function):
    """Forward: kernel 5 on a CUDA batch, its plain version on a CPU batch.
    Backward raises (``_NO_REVERSE``)."""

    @staticmethod
    def forward(ctx, x, widths, dim, *flat):
        params = _unflat(flat)
        if _route(x, "mlp_taylor_bundle"):
            return _bundle_launch(params, x, widths, dim)
        return mlp_taylor_bundle_plain(params, x, dim)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(_NO_REVERSE)


def mlp_taylor_bundle(params, x: torch.Tensor, dim: Optional[int] = None):
    """(value (n, d_out), jac (n, d_out, dim), hdiag (n, d_out, dim)) of a
    tanh MLP ``params`` (list of {kernel, bias}) at every row of ``x``, over
    input columns 0..dim-1 (dim = d_in by default).  Kernel 5 on a CUDA
    batch, its plain version on a CPU batch; forward only on both: a
    gradient taken through the result raises.  Shapes kernel 5 does not
    take raise ValueError on both routes.  A call that needs no gradient
    skips the autograd Function."""
    widths, dim = _check_bundle_shape(params, x, dim)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for p in params for t in (p["kernel"], p["bias"]))):
        return _TaylorBundle.apply(x, widths, dim, *_flat(params))
    if _route(x, "mlp_taylor_bundle"):
        return _bundle_launch(params, x, widths, dim)
    return mlp_taylor_bundle_plain(params, x, dim)


def mlp_taylor_bundle_plain(params, x: torch.Tensor,
                            dim: Optional[int] = None):
    """Plain twin of ``mlp_taylor_bundle``: the closed-form propagation."""
    return mlp_taylor_batched(params, x, int(x.shape[1]) if dim is None
                              else int(dim))
