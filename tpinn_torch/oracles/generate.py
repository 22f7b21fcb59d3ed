"""The cavity cases' data files, made by the port's cavity oracle in the
reference's layout and reused when found:

* steady, in ``OUT/SteadyCase``: ``navier-stokes_cavity_steady.h5`` (the
  (n_out+1)² vertex fields and their coordinates), the 100 × 100
  regular-grid ``navier-stokes_cavity_steady_r.csv`` and the 5,000-point
  random ``navier-stokes_cavity_steady.csv``;
* unsteady, in ``OUT/UnsteadyCase``: one
  ``navier-stokes_SI_cavity_unsteady_%05d.h5`` per output step and the
  regular-grid ``navier-stokes_SI_cavity_unsteady_r.csv`` with a leading
  ``t`` column.

Each h5 gets its ``.xdmf`` wrapper.  Where h5py is not installed the fields
go to ``.npz`` files of the same stems and no ``.xdmf`` is written, since
there is no h5 for one to name.  The oracle runs on the CUDA card unless
``device="cpu"``.  Run with::

    python -m tpinn_torch.oracles.generate [--case steady|unsteady|all] \
        [--out data] [--n-solver 192] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpinn_torch.oracles import cavity, io

STEADY_CSV = "navier-stokes_cavity_steady_r.csv"
STEADY_RANDOM_CSV = "navier-stokes_cavity_steady.csv"
UNSTEADY_CSV = "navier-stokes_SI_cavity_unsteady_r.csv"


def generate_cavity_steady(out_dir: str, U: float = 500.0, nu: float = 1.0,
                           n_solver: int = 192, n_out: int = 100,
                           t_end: float = 50.0, device=None,
                           counts=None) -> str:
    """The steady cavity at Re = U/ν, solved on an ``n_solver`` grid and
    interpolated to the (n_out+1)² vertices, in ``out_dir/SteadyCase``;
    returns that folder.  The fields are dimensional (U·u, U²·p).  Where the
    fields file and the regular-grid csv exist they are kept, and a missing
    random-point csv is derived from the cached fields (an h5 counts as
    a fields file even without h5py; deriving from it then raises).
    ``counts`` (a ``cavity.CGCounts``) collects the pressure solves'
    iterations and host reads when the oracle runs."""
    folder = os.path.join(out_dir, "SteadyCase")
    csv_path = os.path.join(folder, STEADY_CSV)
    rand_csv_path = os.path.join(folder, STEADY_RANDOM_CSV)
    try:
        fields_path = io.find_steady_path(folder)
    except FileNotFoundError:
        fields_path = None
    if fields_path is not None and os.path.exists(csv_path):
        if not os.path.exists(rand_csv_path):
            u_o, v_o, p_o = io.read_fields(fields_path)
            _write_random_csv(rand_csv_path, u_o, v_o, p_o, n_out)
        _ensure_xdmf(fields_path, (n_out + 1) ** 2)
        return folder

    u, v, p = cavity.solve_cavity_steady(re=U / nu, n=n_solver, t_end=t_end,
                                         device=device, counts=counts)
    u, v, p = U * u, U * v, U * U * p

    xq, yq = cavity.vertex_grid(n_out)
    u_o, v_o, p_o = (cavity.interpolate_vertex_field(f, n_solver, xq, yq)
                     for f in (u, v, p))
    fields_path = io.write_fields(io.steady_path(folder, io.fields_ext()),
                                  u_o, v_o, p_o,
                                  geometry=np.stack([xq, yq], axis=-1))

    xg, yg = _regular_grid()
    io.write_regular_csv(
        csv_path, xg, yg,
        *(cavity.interpolate_vertex_field(f, n_solver, xg, yg)
          for f in (u, v, p)))
    _write_random_csv(rand_csv_path, u_o, v_o, p_o, n_out)
    _ensure_xdmf(fields_path, (n_out + 1) ** 2)
    return folder


def _regular_grid():
    """The 100 × 100 points of the regular-grid csv, x fastest."""
    xs = np.linspace(0, 1, 100)
    return (np.array([x for y in xs for x in xs]),
            np.array([y for y in xs for x in xs]))


def _ensure_xdmf(fields_path: str, n_points: int, time: float = 0.0) -> None:
    """The .xdmf wrapper beside a fields h5, unless it exists; none beside
    an npz."""
    if not fields_path.endswith(".h5"):
        return
    xdmf_path = os.path.splitext(fields_path)[0] + ".xdmf"
    if not os.path.exists(xdmf_path):
        io.write_xdmf(xdmf_path, os.path.basename(fields_path), n_points,
                      time=time)


def _write_random_csv(path: str, u_o, v_o, p_o, n_out: int,
                      n_points: int = 5000) -> None:
    """The random-point csv that the csv-driven script slices by position:
    ``n_points`` points drawn from ``default_rng(0)`` (the JAX package's
    draws), the vertex fields interpolated there."""
    rng = np.random.default_rng(0)
    xr = rng.random(n_points)
    yr = rng.random(n_points)
    io.write_regular_csv(
        path, xr, yr,
        *(cavity.interpolate_vertex_field(f, n_out, xr, yr)
          for f in (u_o, v_o, p_o)))


def generate_cavity_unsteady(out_dir: str, U: float = 1.0, nu: float = 1.0,
                             T: float = 1e-2, dt: float = 1e-4, n: int = 100,
                             device=None, counts=None) -> str:
    """The impulsively started cavity (U, ν, horizon T, output step dt, an
    n × n grid) as a per-step series in ``out_dir/UnsteadyCase``; returns
    that folder.  A complete series found there is kept; either way each
    step's h5 gets its .xdmf wrapper and a missing regular-grid csv is
    written from the series.  ``counts`` (a ``cavity.CGCounts``) collects
    the pressure solves' iterations and host reads when the oracle runs."""
    folder = os.path.join(out_dir, "UnsteadyCase")
    n_times = int(round(T / dt))
    csv_path = os.path.join(folder, UNSTEADY_CSV)
    try:
        io.find_unsteady_path(folder, n_times - 1)
    except FileNotFoundError:
        times, snaps = cavity.solve_cavity_unsteady(
            nu=nu, lid_velocity=U, t_end=T, dt_out=dt, n=n, device=device,
            counts=counts)
        paths = io.write_unsteady_series(folder, snaps)
        for path, t, snap in zip(paths, times, snaps):
            _ensure_xdmf(path, snap[0].size, time=t)
        _write_unsteady_regular_csv(csv_path, times, snaps, n)
        return folder
    paths = [io.find_unsteady_path(folder, it) for it in range(n_times)]
    for it, path in enumerate(paths):
        if (path.endswith(".h5")
                and not os.path.exists(os.path.splitext(path)[0] + ".xdmf")):
            _ensure_xdmf(path, io.read_fields(path)[0].size, time=it * dt)
    if not os.path.exists(csv_path):
        _write_unsteady_regular_csv(
            csv_path, [it * dt for it in range(n_times)],
            [io.read_fields(path) for path in paths], n)
    return folder


def _write_unsteady_regular_csv(csv_path: str, times, snaps, n: int) -> None:
    """The series on the 100 × 100 regular grid, step after step, with a
    leading t column."""
    xg, yg = _regular_grid()
    cols = [[] for _ in range(6)]
    for t, snap in zip(times, snaps):
        cols[0].append(np.full(xg.shape, t))
        cols[1].append(xg)
        cols[2].append(yg)
        for c, f in enumerate(snap):
            cols[3 + c].append(cavity.interpolate_vertex_field(f, n, xg, yg))
    t, x, y, u, v, p = (np.concatenate(c) for c in cols)
    io.write_regular_csv(csv_path, x, y, u, v, p, t=t)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=["steady", "unsteady", "all"],
                    default="all")
    ap.add_argument("--out", default="data")
    ap.add_argument("--n-solver", type=int, default=192)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the oracle on "
                         "the CPU")
    args = ap.parse_args(argv)
    if args.case in ("steady", "all"):
        print("generating steady cavity data ...")
        print(" ->", generate_cavity_steady(args.out, n_solver=args.n_solver,
                                            device=args.device))
    if args.case in ("unsteady", "all"):
        print("generating unsteady cavity data ...")
        print(" ->", generate_cavity_unsteady(args.out, device=args.device))


if __name__ == "__main__":
    main()
