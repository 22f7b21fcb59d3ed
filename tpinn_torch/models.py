"""Dense MLP field model.

The reference model is a Keras Sequential MLP: hidden Dense(tanh) layers and
a linear head.  Parameters keep the JAX package's layout, a list of
``{"kernel": (in, out), "bias": (out,)}`` dicts, so weights carry across
unchanged (:mod:`tpinn_torch.bridge`).  ``Model.apply(params, x)`` is the
pure forward used by every loss; the module's own parameters are updated in
place by the optimizer.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpinn_torch import config

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": nn.functional.gelu,
    "sin": torch.sin,
    "linear": lambda x: x,
}


def glorot_uniform(shape, dtype, generator: torch.Generator) -> torch.Tensor:
    """Keras Dense default initializer, drawn on the CPU from ``generator``
    so that a seed gives the same weights on every device."""
    fan_in, fan_out = shape
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return u * (2.0 * limit) - limit


class Model(nn.Module):
    """Dense MLP over per-point inputs (x (N, d_in) -> (N, d_out))."""

    def __init__(
        self,
        layers: Sequence[int],
        activation: str = "tanh",
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
        input_extents: Optional[Sequence] = None,
    ):
        super().__init__()
        if len(layers) < 2:
            raise ValueError("layers must include input and output widths")
        self.layer_sizes = tuple(int(w) for w in layers)
        self.activation_name = activation
        self.activation = _ACTIVATIONS[activation]
        self.dtype = dtype or config.get_dtype()
        self.device = config.resolve_device(device)
        self.input_extents = (
            tuple((float(lo), float(hi)) for lo, hi in input_extents)
            if input_extents is not None
            else None
        )
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.kernels = nn.ParameterList()
        self.biases = nn.ParameterList()
        for p in self.init(generator):
            self.kernels.append(nn.Parameter(p["kernel"].to(self.device)))
            self.biases.append(nn.Parameter(p["bias"].to(self.device)))

    def init(self, generator: torch.Generator) -> List[dict]:
        params = []
        sizes = self.layer_sizes
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            kernel = glorot_uniform((fan_in, fan_out), self.dtype, generator)
            bias = torch.zeros(fan_out, dtype=self.dtype)
            if i == 0 and self.input_extents is not None:
                # input normalization folded into layer 0:
                # x @ W0 + b0 == x̂ @ Ŵ0 + b̂0 with x̂ = (x − mid)/half in
                # (−1, 1)^d, so every compute path (plain, closed-form,
                # CUDA kernel) inherits it through the parameters
                mid = torch.tensor(
                    [(lo + hi) / 2.0 for lo, hi in self.input_extents],
                    dtype=self.dtype,
                )
                half = torch.tensor(
                    [max((hi - lo) / 2.0, 1e-12)
                     for lo, hi in self.input_extents],
                    dtype=self.dtype,
                )
                bias = bias - (mid / half) @ kernel
                kernel = kernel / half[:, None]
            params.append({"kernel": kernel, "bias": bias})
        return params

    @property
    def params(self) -> List[dict]:
        """The live parameters in the JAX package's list-of-dicts layout."""
        return [{"kernel": k, "bias": b}
                for k, b in zip(self.kernels, self.biases)]

    def flat_params(self) -> List[torch.Tensor]:
        """Parameters in (kernel_0, bias_0, kernel_1, ...) order."""
        return [t for p in self.params for t in (p["kernel"], p["bias"])]

    @torch.no_grad()
    def set_params(self, params: Sequence[dict]) -> None:
        """Copy ``params`` (same layout, any device) into the module."""
        for dst, src in zip(self.params, params):
            for key in ("kernel", "bias"):
                dst[key].copy_(torch.as_tensor(src[key]))

    def apply(self, params: Sequence[dict], x: torch.Tensor) -> torch.Tensor:
        """Pure batched forward with explicit params."""
        h = x
        n_layers = len(params)
        for i, layer in enumerate(params):
            h = h @ layer["kernel"] + layer["bias"]
            if i < n_layers - 1:
                h = self.activation(h)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params, x)

    def is_plain_tanh(self) -> bool:
        """True for a plain tanh MLP, the only model the closed-form Taylor
        propagation and the CUDA residual kernels take."""
        return (type(self).apply is Model.apply
                and self.activation_name == "tanh")


def MLP(dim_in: int, dim_out: int, width: int = 32, depth: int = 3,
        activation: str = "tanh", **kw) -> Model:
    """The reference architecture: ``depth`` hidden layers of ``width``
    tanh units and a linear head."""
    return Model([dim_in] + [width] * depth + [dim_out],
                 activation=activation, **kw)
