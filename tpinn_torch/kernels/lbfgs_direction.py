"""The L-BFGS direction as one CUDA kernel (csrc/lbfgs_direction.cu): torch
side.

``lbfgs_direction`` does, in one launch on CUDA vectors, all that
``optimize._scale_by_lbfgs`` does for optax's ``scale_by_lbfgs``: it stores
the newest difference pair and its weight in the ring and returns the
negated two-loop product of the gradient, the descent direction.  It takes
the ring and the previous point as plain tensors; the optimizer's state is
``_scale_by_lbfgs``'s to unpack and move on.  Its plain version is
``_scale_by_lbfgs``'s op sequence, which a CPU tensor takes there; here a
CUDA tensor launches the kernel or raises.  Each launch counts in
``mlp_bundle.LAUNCHES["lbfgs_direction"]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpinn_torch.kernels import build
from tpinn_torch.kernels import mlp_bundle as mb

# the weights and the alphas (2 · m float64) in the 48 KB of shared memory a
# launch gets without opting in
MAX_MEMORY = 2048


def _check(g: torch.Tensor, x: torch.Tensor, g_prev: torch.Tensor,
           x_prev: torch.Tensor, ring_s: torch.Tensor, ring_y: torch.Tensor,
           weights: torch.Tensor, count: int,
           scale_out: Optional[torch.Tensor]) -> None:
    """Raise ValueError unless every tensor is what the kernel takes:
    float32 or float64 vectors of one length n with (m, n) rings and m
    float64 weights, contiguous, all on one CUDA device."""
    if g.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"lbfgs_direction takes float32/float64, not "
                         f"{g.dtype}")
    if g.dim() != 1 or not 1 <= g.shape[0] < 2 ** 31:
        raise ValueError(f"lbfgs_direction takes a vector of 1 to 2**31 - 1 "
                         f"elements, not shape {tuple(g.shape)}")
    if weights.dim() != 1 or not 1 <= weights.shape[0] <= MAX_MEMORY:
        raise ValueError(f"lbfgs_direction takes 1 to {MAX_MEMORY} slots, "
                         f"not weights of shape {tuple(weights.shape)}")
    if count < 0:
        raise ValueError(f"lbfgs_direction: count {count} < 0")
    n, m = g.shape[0], weights.shape[0]
    want = [(g, (n,), g.dtype), (x, (n,), g.dtype), (x_prev, (n,), g.dtype),
            (g_prev, (n,), g.dtype), (ring_s, (m, n), g.dtype),
            (ring_y, (m, n), g.dtype), (weights, (m,), torch.float64)]
    if scale_out is not None:
        want.append((scale_out, (1,), torch.float64))
    for t, shape, dtype in want:
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != g.device):
            raise ValueError(f"lbfgs_direction: a tensor of shape "
                             f"{tuple(t.shape)}, {t.dtype} on {t.device} "
                             f"where {shape}, {dtype} on {g.device} "
                             f"is wanted")
        if not t.is_contiguous():
            raise ValueError("lbfgs_direction takes contiguous tensors")
    if g.device.type != "cuda":
        raise ValueError("lbfgs_direction runs on CUDA tensors only")


def lbfgs_direction(g: torch.Tensor, x: torch.Tensor, g_prev: torch.Tensor,
                    x_prev: torch.Tensor, ring_s: torch.Tensor,
                    ring_y: torch.Tensor, weights: torch.Tensor, count: int,
                    scale_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The descent direction −H·g for the gradient ``g`` at ``x``: the pair
    (x − x_prev, g − g_prev) (zeros at ``count`` 0) and its weight stored at
    slot (count − 1) % m of ``ring_s`` / ``ring_y`` ((m, n)) and ``weights``
    (m float64), then the two-loop product over the ring, negated.  With
    ``scale_out`` (one float64; only tests read it) the identity scale is
    written there too.  One launch on PyTorch's current stream, no host
    read."""
    _check(g, x, g_prev, x_prev, ring_s, ring_y, weights, count, scale_out)
    out = torch.empty_like(g)
    lib = build.library("lbfgs_direction.cu")
    fn = (lib.lbfgs_direction_f64 if g.dtype == torch.float64
          else lib.lbfgs_direction_f32)
    args = (g.data_ptr(), x.data_ptr(), g_prev.data_ptr(), x_prev.data_ptr(),
            ring_s.data_ptr(), ring_y.data_ptr(), weights.data_ptr(),
            out.data_ptr(),
            None if scale_out is None else scale_out.data_ptr(),
            int(count), weights.shape[0], g.shape[0])
    index = g.device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, mb.raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, mb.raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"lbfgs_direction launch failed: cudaError {rc}")
    mb.LAUNCHES["lbfgs_direction"] += 1
    return out
