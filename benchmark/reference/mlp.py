"""The tanh MLP of the configurations, its initial weights from a seed, and
its input derivatives by autograd."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit generator seeds from one whole number of any
    size (seeds may exceed 32 bits)."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(
        n, dtype=np.uint64) >> np.uint64(1)]


def init_params(layers: Sequence[int], extents, generator: torch.Generator
                ) -> List[Dict[str, np.ndarray]]:
    """Glorot-uniform kernels and zero biases in float64 (the Keras Dense
    default), the input box folded into layer 0 so that its inputs are
    (x - mid) / half: the layout {"kernel": (in, out), "bias": (out,)}."""
    params = []
    for i, (fan_in, fan_out) in enumerate(zip(layers[:-1], layers[1:])):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        kernel = (torch.rand((fan_in, fan_out), generator=generator,
                             dtype=torch.float64) * (2.0 * limit) - limit)
        bias = torch.zeros(fan_out, dtype=torch.float64)
        if i == 0:
            mid = torch.tensor([(lo + hi) / 2.0 for lo, hi in extents],
                               dtype=torch.float64)
            half = torch.tensor([(hi - lo) / 2.0 for lo, hi in extents],
                                dtype=torch.float64)
            bias = bias - (mid / half) @ kernel
            kernel = kernel / half[:, None]
        params.append({"kernel": kernel.numpy(), "bias": bias.numpy()})
    return params


def leaves(params) -> List[torch.Tensor]:
    """(kernel_0, bias_0, kernel_1, ...)."""
    return [t for p in params for t in (p["kernel"], p["bias"])]


def as_tensors(params, dtype, device) -> List[Dict[str, torch.Tensor]]:
    return [{k: torch.as_tensor(np.asarray(p[k])).to(device=device,
                                                     dtype=dtype)
             for k in ("kernel", "bias")} for p in params]


def forward(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, p in enumerate(params):
        h = h @ p["kernel"] + p["bias"]
        if i < len(params) - 1:
            h = torch.tanh(h)
    return h


def grad(value: torch.Tensor, leaves):
    """d value / d leaves, zero for a leaf that the value does not read (the
    head's bias under a Laplacian)."""
    return torch.autograd.grad(value, leaves, allow_unused=True,
                               materialize_grads=True)


def derivatives(params, x: torch.Tensor, second: Sequence[int]):
    """(out (B, d_out), jac {k: (B, d_in)}, hdiag {k: (B, d_in)}) with the
    first input derivatives of every output and the pure second ones of the
    outputs in ``second``, all by autograd with their graphs kept, so that
    a loss of them differentiates in the parameters."""
    x = x.detach().requires_grad_(True)
    out = forward(params, x)
    jac = {k: torch.autograd.grad(out[:, k].sum(), x, create_graph=True)[0]
           for k in range(out.shape[1])}
    hdiag = {}
    for k in second:
        cols = [torch.autograd.grad(jac[k][:, j].sum(), x,
                                    create_graph=True)[0][:, j]
                for j in range(x.shape[1])]
        hdiag[k] = torch.stack(cols, dim=1)
    return out, jac, hdiag
