"""Checkpoint and resume: the parameters, the optimizer state and the
history cursor of a run, and the Keras-layout artifacts beside them.

* ``save_checkpoint`` / ``load_checkpoint``: one pickle holding numpy
  arrays only (the parameters as a list of ``{kernel, bias}``, the
  optimizer state with every tensor moved to the host), in the JAX
  package's layout, so each package loads the other's ``checkpoint.pkl``.
* ``save_experiment`` / ``load_experiment``: Model.json, the weights,
  History_Loss.json and checkpoint.pkl in a run folder.  The weights go to
  ``Weights.h5`` where h5py is installed and to ``Weights.npz`` where it is
  not; loading reads ``Weights.h5`` when present, else ``Weights.npz``.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from tpinn_torch import utils
from tpinn_torch.history import History
from tpinn_torch.models import Model, model_from_json

WEIGHTS_FILES = ("Weights.h5", "Weights.npz")


def to_numpy(tree):
    """``tree`` (dicts, lists, tuples) with every tensor as a host numpy
    array; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def save_checkpoint(path, params, opt_state=None, prng_key=None,
                    extra: Optional[dict] = None) -> None:
    """One pickle of the training state, replaced atomically, so that a
    process killed while writing leaves the previous checkpoint whole."""
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    state = {
        "params": to_numpy([{k: p[k] for k in ("kernel", "bias")}
                            for p in params]),
        "opt_state": to_numpy(opt_state),
        "prng_key": None if prng_key is None else np.asarray(prng_key),
        "extra": extra or {},
    }
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, str(path))


def load_checkpoint(path) -> dict:
    """A checkpoint written by ``save_checkpoint`` (of either package)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def weights_file(folder) -> Optional[str]:
    """The run folder's weights: Weights.h5 when present, else Weights.npz,
    else None."""
    for name in WEIGHTS_FILES:
        path = os.path.join(folder, name)
        if os.path.exists(path):
            return path
    return None


def folder_dtype(folder) -> torch.dtype:
    """The float dtype a run folder was trained in: its checkpoint's
    parameters' (float64 where the folder holds no checkpoint)."""
    path = os.path.join(folder, "checkpoint.pkl")
    if not os.path.exists(path):
        return torch.float64
    kernel = load_checkpoint(path)["params"][0]["kernel"]
    return getattr(torch, np.asarray(kernel).dtype.name)


def save_experiment(folder, model: Model, history: Optional[History] = None,
                    opt_state=None, prng_key=None) -> str:
    """Write Model.json, the weights, History_Loss.json and checkpoint.pkl
    into ``folder``; returns the weights file's name (Weights.h5, or
    Weights.npz where h5py is not installed, which is said on stdout)."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "Model.json"), "w") as f:
        f.write(model.to_json())
    name = WEIGHTS_FILES[0] if utils.has_module("h5py") else WEIGHTS_FILES[1]
    if name != WEIGHTS_FILES[0]:
        print(f"save_experiment: h5py is not installed; wrote the weights "
              f"to {name}")
    model.save_weights(os.path.join(folder, name))
    if history is not None:
        history.save(os.path.join(folder, "History_Loss.json"))
    save_checkpoint(os.path.join(folder, "checkpoint.pkl"), model.params,
                    opt_state=opt_state, prng_key=prng_key)
    return name


def load_experiment(folder, device=None):
    """(model, history) from a run folder of either package: the model from
    Model.json on ``device`` with the folder's weights, the history from
    History_Loss.json (None where it is missing)."""
    with open(os.path.join(folder, "Model.json")) as f:
        model = model_from_json(f.read(), device=device)
    weights = weights_file(folder)
    if weights is not None:
        model.load_weights(weights)
    history = None
    hist_path = os.path.join(folder, "History_Loss.json")
    if os.path.exists(hist_path):
        history = History.load(hist_path)
    return model, history
