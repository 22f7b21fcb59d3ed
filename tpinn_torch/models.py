"""Dense MLP field model.

The reference model is a Keras Sequential MLP: hidden Dense(tanh) layers and
a linear head.  Parameters keep the JAX package's layout, a list of
``{"kernel": (in, out), "bias": (out,)}`` dicts, so weights carry across
unchanged (:mod:`tpinn_torch.bridge`).  ``Model.apply(params, x)`` is the
pure forward used by every loss; the module's own parameters are updated in
place by the optimizer.

``to_json`` / ``save_weights`` write the reference artifacts (a Keras
Sequential architecture JSON, and the weights as Keras-layout HDF5 or as an
npz of ``kernel_i`` / ``bias_i``); ``model_from_json`` and ``load_weights``
read them, the JAX package's files included.
"""

from __future__ import annotations

import contextlib
import json
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpinn_torch import config

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    # jax.nn.gelu's default, the tanh approximation
    "gelu": lambda x: nn.functional.gelu(x, approximate="tanh"),
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


class VariablesHandle:
    """Reference to a model's parameters, the ``model.variables`` that
    nisaba's ``ns.OptimizationProblem(model.variables, ...)`` takes.
    ``get()`` returns the live parameters; ``set(params)`` copies values
    into them in place."""

    def __init__(self, model: "Model"):
        self.model = model

    def get(self) -> List[dict]:
        return self.model.params

    def set(self, params: Sequence[dict]) -> None:
        self.model.set_params(params)


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
        # parameters bound by ``bind`` (None: the module's own), and a count
        # of binds that keys the residual memos
        self._bound = None
        self.bind_count = 0
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
        """The live parameters in the JAX package's list-of-dicts layout,
        or, inside ``bind``, the bound ones."""
        if self._bound is not None:
            return self._bound
        return [{"kernel": k, "bias": b}
                for k, b in zip(self.kernels, self.biases)]

    @contextlib.contextmanager
    def bind(self, params: Sequence[dict]):
        """Let ``params`` (same layout, e.g. views of a flat vector that
        requires grad) stand for the model's parameters inside the block:
        every closure that reads ``model.params`` (``model(x)``, the
        residual bundles, the tape losses) is then a function of them, so
        a loss can be differentiated at a given θ (the JAX package's
        ``pb.variables.bind``).  The module's own parameters are not
        touched."""
        prev = self._bound
        self._bound = list(params)
        self.bind_count += 1
        try:
            yield
        finally:
            self._bound = prev
            self.bind_count += 1

    @property
    def variables(self) -> VariablesHandle:
        return VariablesHandle(self)

    def flat_params(self) -> List[torch.Tensor]:
        """Parameters in (kernel_0, bias_0, kernel_1, ...) order."""
        return [t for p in self.params for t in (p["kernel"], p["bias"])]

    @torch.no_grad()
    def set_params(self, params: Sequence[dict]) -> None:
        """Copy ``params`` (same layout, any device) into the module.  The
        layer count and every shape must match: a short list or a wrongly
        shaped array raises ``ValueError`` instead of leaving layers as
        they were or being broadcast over a parameter."""
        params = list(params)
        dst_layers = self.params
        if len(params) != len(dst_layers):
            raise ValueError(f"set_params: {len(params)} layers given for a "
                             f"model of {len(dst_layers)} layers "
                             f"(widths {list(self.layer_sizes)})")
        srcs = []
        for i, (dst, src) in enumerate(zip(dst_layers, params)):
            for key in ("kernel", "bias"):
                t = torch.as_tensor(src[key])
                if tuple(t.shape) != tuple(dst[key].shape):
                    raise ValueError(
                        f"set_params: layer {i} {key!r} has shape "
                        f"{tuple(t.shape)}, the model's is "
                        f"{tuple(dst[key].shape)}")
                srcs.append((dst[key], t))
        for d, t in srcs:
            d.copy_(t)

    def apply(self, params: Sequence[dict], x: torch.Tensor) -> torch.Tensor:
        """Pure batched forward with explicit params."""
        h = x
        n_layers = len(params)
        for i, layer in enumerate(params):
            h = h @ layer["kernel"] + layer["bias"]
            if i < n_layers - 1:
                h = self.activation(h)
        return h

    def forward(self, x) -> torch.Tensor:
        """The model at a batch of any array type (numpy, float32, ...),
        cast to the model's dtype and device; a tensor already of both is
        used as it is, so a watched batch keeps its graph."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        return self.apply(self.params, x)

    # -- Keras-layout artifacts ----------------------------------------------
    def to_json(self) -> str:
        """The Keras Sequential architecture JSON (the reference's
        Model.json) with ``"backend": "torch"``."""
        sizes = self.layer_sizes
        n_dense = len(sizes) - 1
        dtype = str(self.dtype).split(".")[-1]
        layers = []
        for i, units in enumerate(sizes[1:]):
            cfg = {
                "class_name": "Dense",
                "config": {
                    "name": f"dense_{i}",
                    "trainable": True,
                    "dtype": dtype,
                    "units": int(units),
                    "activation": (self.activation_name if i < n_dense - 1
                                   else "linear"),
                    "use_bias": True,
                },
            }
            if i == 0:
                cfg["config"]["batch_input_shape"] = [None, int(sizes[0])]
            layers.append(cfg)
        return json.dumps({
            "class_name": "Sequential",
            "config": {"name": "sequential", "layers": layers},
            "framework": "tpinn",
            "backend": "torch",
        })

    def save_weights(self, path) -> None:
        """Write the weights: ``.h5`` / ``.hdf5`` in the Keras layout
        (h5py, imported here), any other name as an npz."""
        path = str(path)
        arrays = [{k: p[k].detach().cpu().numpy() for k in ("kernel", "bias")}
                  for p in self.params]
        if path.endswith((".h5", ".hdf5")):
            import h5py

            with h5py.File(path, "w") as f:
                names = [f"dense_{i}" for i in range(len(arrays))]
                f.attrs["layer_names"] = [n.encode() for n in names]
                f.attrs["backend"] = b"torch"
                for name, layer in zip(names, arrays):
                    g = f.create_group(name).create_group(name)
                    f[name].attrs["weight_names"] = [
                        f"{name}/kernel:0".encode(), f"{name}/bias:0".encode()]
                    g.create_dataset("kernel:0", data=layer["kernel"])
                    g.create_dataset("bias:0", data=layer["bias"])
        else:
            flat = {}
            for i, layer in enumerate(arrays):
                flat[f"kernel_{i}"] = layer["kernel"]
                flat[f"bias_{i}"] = layer["bias"]
            np.savez(path, **flat)

    def load_weights(self, path) -> None:
        """Read weights written by ``save_weights`` (of either package) into
        the model, in place: ``.h5`` / ``.hdf5`` through h5py (imported
        here), any other name as an npz (``.npz`` appended when missing)."""
        path = str(path)
        params = []
        if path.endswith((".h5", ".hdf5")):
            import h5py

            with h5py.File(path, "r") as f:
                for name in f.attrs["layer_names"]:
                    name = name.decode() if isinstance(name, bytes) else name
                    grp = f[name]
                    if name in grp:
                        grp = grp[name]
                    params.append({"kernel": np.array(grp["kernel:0"]),
                                   "bias": np.array(grp["bias:0"])})
        else:
            with np.load(path if path.endswith(".npz")
                         else path + ".npz") as data:
                i = 0
                while f"kernel_{i}" in data:
                    params.append({"kernel": data[f"kernel_{i}"],
                                   "bias": data[f"bias_{i}"]})
                    i += 1
        self.set_params([{k: torch.as_tensor(p[k], dtype=self.dtype)
                          for k in ("kernel", "bias")} for p in params])

    def is_plain_tanh(self) -> bool:
        """True for a plain tanh MLP, the only model the closed-form Taylor
        propagation and the CUDA residual kernels take."""
        return (type(self).apply is Model.apply
                and self.activation_name == "tanh")


def model_from_json(json_str: str, seed: int = 0, device=None,
                    dtype: Optional[torch.dtype] = None) -> Model:
    """A Model of the architecture in a ``to_json`` (or Keras Sequential)
    string of either package, with fresh weights from ``seed``; the dtype
    is the JSON's unless given."""
    layers_cfg = json.loads(json_str)["config"]["layers"]
    sizes, activation = [], "tanh"
    for i, layer in enumerate(layers_cfg):
        cfg = layer["config"]
        if i == 0 and cfg.get("batch_input_shape"):
            sizes.append(int(cfg["batch_input_shape"][1]))
        sizes.append(int(cfg["units"]))
        if cfg.get("activation") not in (None, "linear"):
            activation = cfg["activation"]
    if dtype is None:
        name = layers_cfg[0]["config"].get("dtype") or "float32"
        dtype = getattr(torch, name, None)
        if not isinstance(dtype, torch.dtype):
            dtype = config.get_dtype()
    return Model(sizes, activation=activation, dtype=dtype, seed=seed,
                 device=device)


def MLP(dim_in: int, dim_out: int, width: int = 32, depth: int = 3,
        activation: str = "tanh", **kw) -> Model:
    """The reference architecture: ``depth`` hidden layers of ``width``
    tanh units and a linear head."""
    return Model([dim_in] + [width] * depth + [dim_out],
                 activation=activation, **kw)
