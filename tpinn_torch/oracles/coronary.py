"""The coronary stenosis oracle: steady (and unsteady) Navier–Stokes on the
gmsh mesh, by the P1-stabilized solvers of :mod:`tpinn_torch.oracles.fem`
on the host.

The reference's data stage solved the case with FEniCS (Taylor–Hood
Newton NS) on the coroParam mesh and wrote ``bpoints.npy`` and the fields
the case reads.  Here the same mesh (``coroParam.msh``, committed with the
package in ``tpinn_torch/oracles/data``) is solved with the P1 solver and
written in the same layout: ``steady_coronary_steady.h5`` holding the
vertex fields and the vertex coordinates, or the ``.npz`` of the same stem
where h5py is missing (:mod:`tpinn_torch.oracles.io`).

Physical parameters of the case: μ = 1e-2, ρ = 1.06e3, ν = 1e4·μ/ρ, a
rotated parabolic inflow with U = 20 across the inlet width
H = √(0.4² + 0.1²).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np

from tpinn_torch.oracles import fem, io
from tpinn_torch.oracles.mesh import read_gmsh

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MESH_PATH = os.path.join(DATA_DIR, "coroParam.msh")
BPOINTS_PATH = os.path.join(DATA_DIR, "bpoints.npy")
# SHA-256 of the committed coroParam.msh and bpoints.npy (the copies in
# DATA_DIR equal the example's byte for byte)
MESH_SHA256 = "e8a2e63fa73d3f5ceb66e121e3ef96eb786c26ab344219c0088c380466a99356"
BPOINTS_SHA256 = \
    "c9c2a22065ab0d8f0867e08822808efb97cc15d1325a2b80cb502cd3fecd7e7f"
STEADY_STEM = "steady_coronary_steady"
# max |·| and L2 norm of u, v, p of the steady fields on the committed mesh
# (picard_iters 30, refine 0), as the committed SteadyCase file holds them
FIELD_NORMS = {
    "u": (6.524725899944023, 357.652831345372),
    "v": (3.5294139475136888, 168.88648288922863),
    "p": (282.8870569509512, 20174.13466281742),
}


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class CoronaryParams:
    mu: float = 1e-2
    rho: float = 1.06e3
    U: float = 20.0
    x0: float = -1.4
    y0: float = -0.8

    @property
    def ni(self) -> float:
        return 1e4 * self.mu / self.rho

    @property
    def H(self) -> float:
        return float(np.sqrt(0.4**2 + 0.1**2))

    @property
    def cos_theta(self) -> float:
        return float(np.cos(np.arctan(1 / 4)))

    @property
    def sin_theta(self) -> float:
        return float(np.sin(np.arctan(1 / 4)))


def inflow_profile(x, prm: CoronaryParams = CoronaryParams()):
    """The rotated parabolic inflow (u, v) at the points ``x`` (N, 2)."""
    x = np.asarray(x)
    s = np.sqrt((x[:, 0] - prm.x0) ** 2 + (x[:, 1] - prm.y0) ** 2) / prm.H
    mag = prm.U * s * (1.0 - s)
    return prm.cos_theta * mag, prm.sin_theta * mag


def refine_uniform(nodes: np.ndarray, triangles: np.ndarray):
    """One level of uniform (red) refinement through the edge midpoints.

    The original vertices keep their indices (0 … M−1), so a field solved
    on the refined mesh restricts to the original nodes by slicing (P1
    velocity error ~ h²: one level gives about 4× more accurate data on the
    case's node set)."""
    edges: dict = {}
    mids = []

    def mid(a: int, b: int) -> int:
        key = (a, b) if a < b else (b, a)
        idx = edges.get(key)
        if idx is None:
            idx = len(nodes) + len(mids)
            edges[key] = idx
            mids.append(0.5 * (nodes[key[0]] + nodes[key[1]]))
        return idx

    tris = []
    for a, b, c in triangles:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        tris.extend([[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]])
    new_nodes = np.concatenate([nodes, np.asarray(mids)], axis=0)
    return new_nodes, np.asarray(tris, dtype=triangles.dtype)


def classify_boundary(nodes2d: np.ndarray, bidx: np.ndarray,
                      tol: float = 1e-12) -> np.ndarray:
    """Flags of the boundary vertices ``bidx`` by the case's line
    predicates: 1 inflow (y + 4x + 6.4 = 0), 2 outflow 1 (y + 2x − 4.8 =
    0), 3 outflow 2 (x = 1.2, y < 0), 0 the wall.  Edge midpoints of a
    marked segment satisfy the same line, so refined meshes classify
    too."""
    x, y = nodes2d[bidx, 0], nodes2d[bidx, 1]
    marks = np.zeros(len(bidx), dtype=np.int64)
    marks[np.abs(y + 4.0 * x + 6.4) < tol] = 1
    marks[np.abs(y + 2.0 * x - 4.8) < tol] = 2
    marks[np.logical_and(np.abs(x - 1.2) < tol, y < 0)] = 3
    return marks


def boundary_vertices_of(tris: np.ndarray) -> np.ndarray:
    """Indices of the vertices on the exterior boundary: the vertices of
    triangle edges that belong to one triangle only."""
    edges = np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0)
    edges = np.sort(edges, axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    bnd_edges = uniq[counts == 1]
    return np.unique(bnd_edges.reshape(-1))


def boundary_vertices(mesh) -> np.ndarray:
    return boundary_vertices_of(mesh.triangles)


def generate_bpoints(msh_path: str, tol: float = 1e-14) -> np.ndarray:
    """The labeled boundary points (N, 4) [x, y, z, flag] of a mesh: flag
    1 on the inflow line, 2 on outflow 1, 3 on outflow 2, 0 on the wall
    (``classify_boundary``'s predicates at ``tol``), in vertex order."""
    mesh = read_gmsh(msh_path)
    bidx = boundary_vertices(mesh)
    pts = mesh.nodes[bidx]  # (N, 3)
    x, y = pts[:, 0], pts[:, 1]
    inflow = np.abs(y + 4.0 * x + 6.4) < tol
    outflow1 = np.abs(y + 2.0 * x - 4.8) < tol
    outflow2 = np.logical_and(np.abs(x - 1.2) < tol, y < 0)
    marks = (1 * inflow.astype(np.int64) + 2 * outflow1.astype(np.int64)
             + 3 * outflow2.astype(np.int64))
    return np.hstack([pts, marks[:, None].astype(pts.dtype)])


def match_boundary_nodes(nodes: np.ndarray, bpoints: Dict[str, np.ndarray],
                         tol: float = 1e-8) -> Dict[str, np.ndarray]:
    """The mesh node indices of the labeled ``bpoints`` coordinates (the
    nearest node within max(tol, 1e-6); every nearest node where none is
    that close)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(nodes[:, :2])
    out = {}
    for name, pts in bpoints.items():
        dist, idx = tree.query(pts)
        out[name] = np.unique(idx[dist < max(tol, 1e-6)])
        if len(out[name]) == 0 and len(pts):
            out[name] = np.unique(idx)
    return out


def _refined(msh_path: str, refine: int):
    mesh = read_gmsh(msh_path)
    nodes, tris = mesh.nodes[:, :2], mesh.triangles
    for _ in range(int(refine)):
        nodes, tris = refine_uniform(nodes, tris)
    return nodes, tris, mesh.nodes.shape[0]


def _dirichlet(nodes, nosl, inf, prm) -> Dict[int, Tuple[float, float]]:
    """No slip on the wall nodes, the inflow profile on the inflow
    nodes."""
    dirichlet: Dict[int, Tuple[float, float]] = {}
    for i in nosl:
        dirichlet[int(i)] = (0.0, 0.0)
    u_in, v_in = inflow_profile(nodes[inf], prm)
    for i, uu, vv in zip(inf, u_in, v_in):
        dirichlet[int(i)] = (float(uu), float(vv))
    return dirichlet


def solve_coronary(msh_path: str, bpoints_path: Optional[str] = None,
                   prm: CoronaryParams = CoronaryParams(),
                   picard_iters: int = 30, verbose: bool = False,
                   refine: int = 0, counts: Optional[dict] = None):
    """Steady NS on the coronary mesh; returns (nodes2d, u, v, p).

    Without ``bpoints_path`` (or with ``refine``) the boundary is
    classified geometrically (``classify_boundary``); with it the labeled
    points are matched to mesh nodes.  ``refine`` levels of uniform
    refinement come before the solve, whose fields are restricted back to
    the original nodes.  The outflows stay natural (do-nothing, traction
    free), the condition the case's Neumann losses encode.
    ``counts["picard"]`` gets the Picard solves."""
    nodes, tris, n_orig = _refined(msh_path, refine)
    if refine == 0 and bpoints_path is not None:
        bidx = match_boundary_nodes(nodes, io.load_bpoints(bpoints_path))
        nosl, inf = bidx["NOSL"], bidx["INF"]
    else:
        ball = boundary_vertices_of(tris)
        marks = classify_boundary(nodes, ball)
        nosl, inf = ball[marks == 0], ball[marks == 1]
    u, v, p = fem.solve_navier_stokes(
        nodes, tris, nu=prm.ni, dirichlet=_dirichlet(nodes, nosl, inf, prm),
        picard_iters=picard_iters, verbose=verbose, counts=counts)
    return nodes[:n_orig], u[:n_orig], v[:n_orig], p[:n_orig]


def outflow_edges(nodes2d: np.ndarray, tris: np.ndarray,
                  tol: float = 1e-12) -> np.ndarray:
    """The boundary edges on the two outflow lines (outflow 1: y + 2x −
    4.8 = 0; outflow 2: x = 1.2 with y < 0): both end points satisfy the
    line's predicate."""
    edges, _, _ = fem.boundary_edges_with_normals(nodes2d, tris)
    x, y = nodes2d[:, 0], nodes2d[:, 1]
    on1 = np.abs(y + 2.0 * x - 4.8) < tol
    on2 = np.abs(x - 1.2) < tol
    a, b = edges[:, 0], edges[:, 1]
    mid_y = 0.5 * (y[a] + y[b])
    sel = (on1[a] & on1[b]) | (on2[a] & on2[b] & (mid_y < 0))
    return edges[sel]


def solve_coronary_unsteady(msh_path: str,
                            prm: CoronaryParams = CoronaryParams(),
                            t_end: float = 1e-2, dt: float = 1e-4,
                            refine: int = 0, verbose: bool = False):
    """Semi-implicit unsteady NS on the coronary mesh: the wall and the
    inflow profile as Dirichlet data, the (p/ν)(n·v) surface term on both
    outflows.  Returns (nodes2d, times, snaps), one nodal (u, v, p) per
    time step, restricted to the original nodes."""
    nodes, tris, n_orig = _refined(msh_path, refine)
    ball = boundary_vertices_of(tris)
    marks = classify_boundary(nodes, ball)
    times, snaps = fem.solve_navier_stokes_unsteady(
        nodes, tris, nu=prm.ni,
        dirichlet=_dirichlet(nodes, ball[marks == 0], ball[marks == 1], prm),
        t_end=t_end, dt=dt, pressure_outflow_edges=outflow_edges(nodes, tris),
        verbose=verbose)
    snaps = [(u[:n_orig], v[:n_orig], p[:n_orig]) for u, v, p in snaps]
    return nodes[:n_orig], times, snaps


def _folder(out_dir: str, name: str, refine: int) -> str:
    return os.path.join(out_dir, name if not refine else f"{name}_r{int(refine)}")


def generate_coronary_unsteady(out_dir: str, msh_path: str,
                               prm: CoronaryParams = CoronaryParams(),
                               t_end: float = 1e-2, dt: float = 1e-4,
                               refine: int = 0, verbose: bool = False) -> str:
    """The unsteady series in ``OUT/Coronary`` (``Coronary_r<k>`` with
    ``refine``): one ``navier-stokes_SI_coronary_unsteady_%05d`` fields file
    per step (h5 with its ``.xdmf`` wrapper, or npz without h5py) and
    ``bpoints.npy``; returns the folder, where a finished series is kept."""
    folder = _folder(out_dir, "Coronary", refine)
    n_times = len(np.arange(0.0, t_end, step=dt))
    bp_out = os.path.join(folder, "bpoints.npy")
    try:
        io.find_unsteady_path(folder, n_times - 1, "coronary")
        if os.path.exists(bp_out):
            return folder
    except FileNotFoundError:
        pass
    nodes, times, snaps = solve_coronary_unsteady(
        msh_path, prm, t_end=t_end, dt=dt, refine=refine, verbose=verbose)
    ext = io.fields_ext()
    for it, ((u, v, p), t) in enumerate(zip(snaps, times)):
        path = io.write_fields(io.unsteady_path(folder, it, ext, "coronary"),
                               u, v, p, geometry=nodes)
        if ext == ".h5":
            io.write_xdmf(os.path.splitext(path)[0] + ".xdmf",
                          os.path.basename(path), len(nodes), time=float(t))
    np.save(bp_out, generate_bpoints(msh_path))
    return folder


def steady_fields_path(folder: str) -> str:
    """The steady fields file in ``folder`` (h5 or npz, see
    ``io.find_fields``)."""
    return io.find_fields(os.path.join(folder, STEADY_STEM))


def generate_coronary(out_dir: str, msh_path: str,
                      bpoints_path: Optional[str] = None,
                      prm: CoronaryParams = CoronaryParams(),
                      verbose: bool = False, refine: int = 0,
                      counts: Optional[dict] = None) -> str:
    """``steady_coronary_steady`` (h5, or npz without h5py) and
    ``bpoints.npy`` in ``OUT/SteadyCase`` (``SteadyCase_r<k>`` with
    ``refine``, so refined data never replaces the data a run trained on);
    returns the folder.  Found files (either layout) are kept.  The
    boundary points are derived from the mesh unless a file is given."""
    folder = _folder(out_dir, "SteadyCase", refine)
    bp_out = os.path.join(folder, "bpoints.npy")
    try:
        steady_fields_path(folder)
        if os.path.exists(bp_out):
            return folder
    except FileNotFoundError:
        pass
    nodes, u, v, p = solve_coronary(msh_path, bpoints_path, prm,
                                    verbose=verbose, refine=refine,
                                    counts=counts)
    io.write_fields(os.path.join(folder, STEADY_STEM + io.fields_ext()),
                    u, v, p, geometry=nodes)
    bp = (np.load(bpoints_path) if bpoints_path is not None
          else generate_bpoints(msh_path))
    np.save(bp_out, bp)
    return folder
