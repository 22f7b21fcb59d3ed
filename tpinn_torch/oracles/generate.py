"""The unsteady cavity's data series, made by the port's cavity oracle:
``OUT/UnsteadyCase/navier-stokes_SI_cavity_unsteady_%05d.h5`` (or ``.npz``
where h5py is not installed), one file per output step; a complete series
found there is reused.  The oracle runs on the CUDA card unless
``device="cpu"``.
"""

from __future__ import annotations

import os

from tpinn_torch.oracles import cavity, io


def generate_cavity_unsteady(out_dir: str, U: float = 1.0, nu: float = 1.0,
                             T: float = 1e-2, dt: float = 1e-4, n: int = 100,
                             device=None, counts=None) -> str:
    """The impulsively started cavity (U, ν, horizon T, output step dt, an
    n × n grid) as a per-step series in ``out_dir/UnsteadyCase``; returns
    that folder.  ``counts`` (a ``cavity.CGCounts``) collects the pressure
    solves' iterations and host reads when the oracle runs."""
    folder = os.path.join(out_dir, "UnsteadyCase")
    n_times = int(round(T / dt))
    try:
        io.find_unsteady_path(folder, n_times - 1)
        return folder
    except FileNotFoundError:
        pass
    _, snaps = cavity.solve_cavity_unsteady(nu=nu, lid_velocity=U, t_end=T,
                                            dt_out=dt, n=n, device=device,
                                            counts=counts)
    io.write_unsteady_series(folder, snaps)
    return folder
