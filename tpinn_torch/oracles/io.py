"""Readers and writers of the cavity oracle's per-step data files.

The unsteady cavity data is a series of per-step files
``navier-stokes_SI_cavity_unsteady_%05d.h5`` holding

    VisualisationVector/0 : (M, 2) velocity at the (n+1)² mesh vertices
    VisualisationVector/1 : (M,)   pressure

(vertices x fastest), the reference's layout.  Where h5py is not installed
the same arrays go to ``...%05d.npz`` files under the same two names, and
the reader takes whichever of the two it finds.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from tpinn_torch import utils

_VEL, _PRES = "VisualisationVector/0", "VisualisationVector/1"


def write_fields(path: str, u, v, p) -> str:
    """One step's fields at ``path`` (its extension .h5 or .npz); returns
    the path written."""
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    vel, pres = np.stack([u, v], axis=-1), np.asarray(p)
    if path.endswith(".h5"):
        import h5py

        with h5py.File(path, "w") as f:
            vis = f.create_group("VisualisationVector")
            vis.create_dataset("0", data=vel)
            vis.create_dataset("1", data=pres)
    else:
        np.savez(path, **{_VEL: vel, _PRES: pres})
    return path


def read_fields(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(u, v, p) of one step's file (.h5 or .npz)."""
    if path.endswith(".h5"):
        import h5py

        with h5py.File(path, "r") as f:
            vel = np.asarray(f["VisualisationVector"]["0"])
            p = np.asarray(f["VisualisationVector"]["1"])
    else:
        with np.load(path) as f:
            vel, p = f[_VEL], f[_PRES]
    if p.ndim == 2:
        p = p[:, 0]
    return vel[:, 0], vel[:, 1], p


def unsteady_path(folder: str, step: int, ext: str = ".h5") -> str:
    return os.path.join(folder,
                        f"navier-stokes_SI_cavity_unsteady_{step:05d}{ext}")


def find_unsteady_path(folder: str, step: int) -> str:
    """The step's file, .h5 first, else .npz; FileNotFoundError if neither
    exists."""
    for ext in (".h5", ".npz"):
        path = unsteady_path(folder, step, ext)
        if os.path.exists(path) and (ext != ".h5"
                                     or utils.has_module("h5py")):
            return path
    raise FileNotFoundError(unsteady_path(folder, step, ".{h5,npz}"))


def write_unsteady_series(folder: str, snaps: Sequence[Tuple]) -> list:
    """One file per step, h5 where h5py is installed, else npz."""
    ext = ".h5" if utils.has_module("h5py") else ".npz"
    return [write_fields(unsteady_path(folder, it, ext), u, v, p)
            for it, (u, v, p) in enumerate(snaps)]


def read_unsteady_series(folder: str, n_times: int):
    """The steps 0 … n_times − 1 concatenated, each step's pressure
    recentred on its mean, as the reference's ingest loop does."""
    us, vs, ps = [], [], []
    for it in range(n_times):
        u, v, p = read_fields(find_unsteady_path(folder, it))
        us.append(u)
        vs.append(v)
        ps.append(p - np.mean(p))
    return np.concatenate(us), np.concatenate(vs), np.concatenate(ps)
