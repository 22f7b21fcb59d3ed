"""Readers and writers of the cavity oracle's data files, in the reference's
layouts.

* Fields files (the steady ``navier-stokes_cavity_steady.h5`` and the
  unsteady per-step ``navier-stokes_SI_cavity_unsteady_%05d.h5``) hold

      VisualisationVector/0 : (M, 2) velocity at the (n+1)² mesh vertices
      VisualisationVector/1 : (M,)   pressure
      Mesh/0/mesh/geometry  : (M, 2) vertex coordinates (steady file only)

  (vertices x fastest).  Where h5py is not installed the same arrays go to
  a ``.npz`` of the same stem under the same names, and the readers take
  whichever of the two they find (an h5 that is there counts as found even
  without h5py: reading it then raises, and nothing is solved again).
* Regular-grid and random-point csv files, header ``x,y,ux,uy,p`` (the
  unsteady file has a leading ``t`` column), written and read with numpy
  alone: each value is written as its shortest round-trip repr (the text
  pandas writes), so it reads back exactly.
* The ``.xdmf`` wrapper naming a fields h5, as plain text.

Every writer writes a temporary file beside the target and renames it over
the target, so a symlinked target (committed data linked into a run's data
folder) is replaced and never written through.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

from tpinn_torch import utils

_VEL, _PRES = "VisualisationVector/0", "VisualisationVector/1"
_GEOM = "Mesh/0/mesh/geometry"
STEADY_STEM = "navier-stokes_cavity_steady"


def fields_ext() -> str:
    """The extension a new fields file takes: .h5 where h5py is installed,
    else .npz."""
    return ".h5" if utils.has_module("h5py") else ".npz"


def _temporary(path: str) -> str:
    """A name beside ``path`` with its extension (np.savez keeps a .npz
    name as given), for writing before the rename."""
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    root, ext = os.path.splitext(path)
    return f"{root}.tmp{os.getpid()}{ext}"


def _require_h5py(path: str) -> None:
    if not utils.has_module("h5py"):
        raise ImportError(f"{path} is an h5 file and h5py is not installed; "
                          "install h5py or remove the file to make it anew")


def write_fields(path: str, u, v, p, geometry=None) -> str:
    """One set of vertex fields at ``path`` (its extension .h5 or .npz),
    with the vertex coordinates when ``geometry`` (M, 2) is given; returns
    the path written."""
    arrays = {_VEL: np.stack([u, v], axis=-1), _PRES: np.asarray(p)}
    if geometry is not None:
        arrays[_GEOM] = np.asarray(geometry)
    tmp = _temporary(path)
    if path.endswith(".h5"):
        import h5py

        with h5py.File(tmp, "w") as f:
            for name, a in arrays.items():
                f.create_dataset(name, data=a)
    else:
        np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def read_fields(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(u, v, p) of a fields file (.h5 or .npz)."""
    if path.endswith(".h5"):
        _require_h5py(path)
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


def read_mesh_geometry(path: str) -> np.ndarray:
    """The (M, 2) vertex coordinates of a steady fields file (.h5 or
    .npz)."""
    if path.endswith(".h5"):
        _require_h5py(path)
        import h5py

        with h5py.File(path, "r") as f:
            return np.asarray(f["Mesh"]["0"]["mesh"]["geometry"])
    with np.load(path) as f:
        return f[_GEOM]


def _find(stem: str) -> str:
    """``stem`` with the extension a new file takes (``fields_ext``) where
    that exists, else with the other; FileNotFoundError if neither
    exists."""
    first = fields_ext()
    for ext in (first, ".npz" if first == ".h5" else ".h5"):
        if os.path.exists(stem + ext):
            return stem + ext
    raise FileNotFoundError(stem + ".{h5,npz}")


def steady_path(folder: str, ext: str = ".h5") -> str:
    return os.path.join(folder, STEADY_STEM + ext)


def find_steady_path(folder: str) -> str:
    """The steady fields file in ``folder`` (see ``_find``)."""
    return _find(steady_path(folder, ""))


def unsteady_path(folder: str, step: int, ext: str = ".h5") -> str:
    return os.path.join(folder,
                        f"navier-stokes_SI_cavity_unsteady_{step:05d}{ext}")


def find_unsteady_path(folder: str, step: int) -> str:
    """The step's fields file (see ``_find``)."""
    return _find(unsteady_path(folder, step, ""))


def write_unsteady_series(folder: str, snaps: Sequence[Tuple]) -> list:
    """One file per step, h5 where h5py is installed, else npz."""
    ext = fields_ext()
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


def write_regular_csv(path: str, x, y, ux, uy, p, t=None) -> None:
    """The csv ``[t,]x,y,ux,uy,p``, one row per point, each value its
    shortest round-trip repr."""
    names = (["t"] if t is not None else []) + ["x", "y", "ux", "uy", "p"]
    cols = ([t] if t is not None else []) + [x, y, ux, uy, p]
    text = [np.asarray(c, dtype=np.float64).reshape(-1).astype(str)
            for c in cols]
    tmp = _temporary(path)
    with open(tmp, "w") as f:
        f.write(",".join(names) + "\n")
        f.writelines(",".join(row) + "\n" for row in zip(*text))
    os.replace(tmp, path)


def read_regular_csv(path: str) -> Dict[str, np.ndarray]:
    """The columns of a csv written by ``write_regular_csv`` (or by the
    reference's pandas writer) by name, as float64 arrays."""
    with open(path) as f:
        names = f.readline().strip().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                      ndmin=2)
    return {name: data[:, i] for i, name in enumerate(names)}


def write_xdmf(path: str, h5_filename: str, n_points: int,
               time: float = 0.0) -> None:
    """The XDMF wrapper naming the fields of ``h5_filename`` (the
    reference's FEM stage writes .xdmf + .h5 pairs; only the h5 is read)."""
    xml = f"""<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Time Value="{time}" />
      <Attribute Name="u" AttributeType="Vector" Center="Node">
        <DataItem Dimensions="{n_points} 2" Format="HDF">{h5_filename}:/VisualisationVector/0</DataItem>
      </Attribute>
      <Attribute Name="p" AttributeType="Scalar" Center="Node">
        <DataItem Dimensions="{n_points}" Format="HDF">{h5_filename}:/VisualisationVector/1</DataItem>
      </Attribute>
    </Grid>
  </Domain>
</Xdmf>
"""
    tmp = _temporary(path)
    with open(tmp, "w") as f:
        f.write(xml)
    os.replace(tmp, path)
