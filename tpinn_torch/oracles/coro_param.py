"""The parametric coronary-bifurcation geometry and its mesher (no gmsh).

The case's geometry (``coroParam.geo``) is a closed loop of nine gmsh
curves (degree-4 Béziers and straight inflow / outflow segments) whose two
stenosis bumps are set by ``sten1`` / ``sten2`` (point 13 is
``{0.9, 0.7 - 0.2·sten1/100}``, point 36 ``{0.6, -0.3 - 0.2·sten2/100}``).
This module triangulates the same domain from the same parameters with a
DistMesh-style force-equilibrium mesher (Persson & Strang 2004) on scipy's
Delaunay, and writes the result in gmsh 4.1 ASCII, which
:func:`tpinn_torch.oracles.mesh.read_gmsh` reads.

Boundary nodes are sampled on the exact curves and pinned while meshing,
so the straight-line boundary predicates (inflow y + 4x + 6.4 = 0,
outflow 1 y + 2x − 4.8 = 0, outflow 2 x = 1.2 with y < 0) label the mesh
exactly.  Inside / outside comes from an even-odd ray-casting test in
numpy (``points_in_polygon``), the crossing test matplotlib's
``Path.contains_points`` makes, so no plotting library is needed.  scipy
is imported inside ``mesh_coronary``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CoroGeoParams:
    """coroParam.geo's parameters (values at coroParam.geo:4-9)."""

    sten1: float = 50.0   # % — upper-branch stenosis severity
    sten2: float = 150.0  # % — lower-branch stenosis severity
    ref1: float = 0.1     # local mesh sizes at control points
    ref2: float = 0.05
    ref3: float = 0.5
    # global size multiplier: the committed coroParam.msh is much finer than
    # the raw .geo sizes (gmsh was run with a refinement factor); 0.042
    # reproduces its ~10.8k-node density (calibrated: 0.155 -> 1,927 nodes,
    # 0.065 -> 5,708, scaling sub-quadratically because the gradation cap
    # ref3·size_factor shrinks with the factor)
    size_factor: float = 0.042


def _control_points(prm: CoroGeoParams) -> Dict[int, Tuple[float, float]]:
    """gmsh point tag -> (x, y), with the two parametric stenosis points."""
    return {
        2: (1.0, 0.5), 3: (0.0, 0.0), 5: (0.5, 0.4), 6: (2.0, 0.8),
        8: (1.5, 0.5), 11: (1.9, 1.0), 12: (1.4, 0.7),
        13: (0.9, 0.7 - 0.2 * (prm.sten1 / 100.0)),
        14: (0.4, 0.6), 15: (-0.1, 0.2), 18: (-0.5, 0.0),
        19: (-1.0, -0.3), 22: (-1.25, -0.3), 23: (-1.5, -0.4),
        27: (-1.4, -0.8), 28: (-1.15, -0.7), 29: (-0.9, -0.7),
        30: (-0.4, -0.4), 31: (-0.15, -0.25), 33: (0.3, -0.2),
        34: (0.3, -0.4), 35: (0.6, -0.5),
        36: (0.6, -0.3 - 0.2 * (prm.sten2 / 100.0)),
        37: (0.9, -0.4), 38: (1.2, -0.4), 39: (1.2, -0.6), 40: (0.9, -0.6),
    }


def _point_sizes(prm: CoroGeoParams) -> Dict[int, float]:
    """Per-control-point target sizes (the ref1/ref2/ref3 of the .geo)."""
    sizes = {tag: prm.ref1 for tag in _control_points(prm)}
    sizes[3] = prm.ref2
    for tag in (6, 11, 23, 27, 38, 39):
        sizes[tag] = prm.ref3
    return sizes


# Curve Loop(1) = {5, 6, 7, 8, 9, 1, 2, 3, 4} — curve id -> control tags,
# in loop order.  'line' = straight segment, 'bezier' = gmsh Bezier
# (Bernstein of degree n_ctrl - 1).
_LOOP: List[Tuple[int, str, Tuple[int, ...]]] = [
    (5, "line", (23, 27)),            # inflow        (Physical Curve 10)
    (6, "bezier", (27, 28, 29, 30, 31)),
    (7, "bezier", (31, 34, 35, 40, 39)),
    (8, "line", (39, 38)),            # outflow 2     (Physical Curve 13)
    (9, "bezier", (38, 37, 36, 33, 3)),
    (1, "bezier", (3, 5, 2, 8, 6)),
    (2, "line", (6, 11)),             # outflow 1     (Physical Curve 16)
    (3, "bezier", (11, 12, 13, 14, 15)),
    (4, "bezier", (15, 18, 19, 22, 23)),
]


def _bezier(ctrl: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Bernstein Bézier of degree len(ctrl)-1 at params t — (len(t), 2)."""
    n = len(ctrl) - 1
    from math import comb

    t = np.asarray(t)[:, None]
    out = np.zeros((t.shape[0], 2))
    for i, p in enumerate(ctrl):
        out += comb(n, i) * (1 - t) ** (n - i) * t**i * np.asarray(p)
    return out


def boundary_polyline(prm: CoroGeoParams):
    """Sample the closed loop at the local size field.

    Returns (pts (N,2) in loop order, sizes (N,) local target size at each
    point).  Straight segments are sampled by exact linear interpolation so
    the inflow/outflow line predicates hold to machine precision; each
    curve's spacing follows the .geo sizes interpolated between its control
    points, scaled by ``size_factor``.
    """
    ctrl_pts = _control_points(prm)
    ctrl_sz = _point_sizes(prm)
    pts_out, sz_out = [], []
    for _cid, kind, tags in _LOOP:
        ctrl = np.asarray([ctrl_pts[t] for t in tags])
        szs = np.asarray([ctrl_sz[t] for t in tags]) * prm.size_factor
        # dense probe to get arc length + local size along the curve
        tt = np.linspace(0.0, 1.0, 512)
        probe = (ctrl[0] + tt[:, None] * (ctrl[-1] - ctrl[0])
                 if kind == "line" else _bezier(ctrl, tt))
        seg = np.linalg.norm(np.diff(probe, axis=0), axis=1)
        s = np.concatenate([[0.0], np.cumsum(seg)])
        h_probe = np.interp(tt, np.linspace(0, 1, len(szs)), szs)
        # place points by integrating ds / h(s)
        dens = np.concatenate(
            [[0.0], np.cumsum(seg / (0.5 * (h_probe[1:] + h_probe[:-1])))]
        )
        n_pts = max(2, int(round(dens[-1])))
        targets = np.linspace(0.0, dens[-1], n_pts + 1)[:-1]  # drop curve end
        t_at = np.interp(targets, dens, tt)
        t_at[0] = 0.0
        if kind == "line":
            p = ctrl[0] + t_at[:, None] * (ctrl[-1] - ctrl[0])
        else:
            p = _bezier(ctrl, t_at)
            p[0] = ctrl[0]  # endpoints exact
        pts_out.append(p)
        sz_out.append(np.interp(t_at, np.linspace(0, 1, len(szs)), szs))
    return np.concatenate(pts_out), np.concatenate(sz_out)


def points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Whether each point lies inside the closed polygon ``poly`` (its last
    vertex joined to its first), by the even-odd rule: the parity of the
    edges a ray from the point towards +x crosses.  An edge (x0, y0) →
    (x1, y1) whose ends lie on either side of the point's y, (y0 ≥ y) ≠
    (y1 ≥ y), crosses when ((y1 − y) (x0 − x1) ≥ (x1 − x) (y0 − y1))
    equals (y1 ≥ y): the test, in the same arithmetic, of matplotlib's
    ``Path.contains_points`` (radius 0).  Each edge visits only the points
    in its band of y (the points sorted by y once)."""
    tx, ty = pts[:, 0], pts[:, 1]
    order = np.argsort(ty, kind="stable")
    ys = ty[order]
    crossings = np.zeros(len(pts), dtype=np.int64)
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    # the ends lie on either side exactly when min(y0, y1) < y <= max(...)
    lo = np.searchsorted(ys, np.minimum(y0, y1), side="right")
    hi = np.searchsorted(ys, np.maximum(y0, y1), side="right")
    for k in np.nonzero(hi > lo)[0]:
        idx = order[lo[k]:hi[k]]
        yflag1 = y1[k] >= ty[idx]
        cross = ((y1[k] - ty[idx]) * (x0[k] - x1[k])
                 >= (x1[k] - tx[idx]) * (y0[k] - y1[k])) == yflag1
        crossings[idx] += cross
    return crossings % 2 == 1


def _signed_distance(pts, poly):
    """Distance to the closed polyline; negative inside."""
    a = poly
    b = np.roll(poly, -1, axis=0)
    ab = b - a
    ab2 = np.maximum((ab**2).sum(1), 1e-30)
    # distance from each pt to each segment, min over segments (chunked)
    d = np.empty(len(pts))
    chunk = 2048
    for i0 in range(0, len(pts), chunk):
        p = pts[i0:i0 + chunk]
        t = ((p[:, None, :] - a[None]) * ab[None]).sum(-1) / ab2[None]
        t = np.clip(t, 0.0, 1.0)
        proj = a[None] + t[..., None] * ab[None]
        d[i0:i0 + chunk] = np.sqrt(
            ((p[:, None, :] - proj) ** 2).sum(-1)
        ).min(1)
    return np.where(points_in_polygon(pts, poly), -d, d)


def mesh_coronary(prm: CoroGeoParams = CoroGeoParams(), max_iter: int = 80,
                  seed: int = 0):
    """DistMesh-style triangulation of the parametric domain.

    Returns (nodes (M,2), triangles (T,3)).  Boundary polyline nodes are
    fixed; interior nodes relax under the standard DistMesh bar forces with
    the size field h(x) = local boundary size + 0.3·distance-to-boundary
    (gradation), capped at ref3·size_factor.
    """
    from scipy.spatial import Delaunay, cKDTree

    bnd, bnd_sz = boundary_polyline(prm)
    h_cap = prm.ref3 * prm.size_factor
    tree = cKDTree(bnd)

    def h_field(p):
        dist, idx = tree.query(p)
        return np.minimum(bnd_sz[idx] + 0.3 * dist, h_cap)

    # initial interior points: hex grid at the finest size, thinned by
    # rejection sampling with probability (h_min / h)^2
    h0 = float(bnd_sz.min())
    x0, y0 = bnd.min(0) - 0.05
    x1, y1 = bnd.max(0) + 0.05
    gx, gy = np.meshgrid(np.arange(x0, x1, h0),
                         np.arange(y0, y1, h0 * np.sqrt(3) / 2))
    gx[1::2] += h0 / 2  # hex offset
    p = np.stack([gx.ravel(), gy.ravel()], axis=1)
    p = p[_signed_distance(p, bnd) < -0.5 * h0]  # strictly interior
    rng = np.random.default_rng(seed)
    keep = rng.random(len(p)) < (h0 / h_field(p)) ** 2
    p = p[keep]

    n_fix = len(bnd)
    pts = np.concatenate([bnd, p])

    def triangulate(pts):
        tri = Delaunay(pts).simplices
        cent = pts[tri].mean(axis=1)
        return tri[_signed_distance(cent, bnd) < 0.0]

    Fscale, dt = 1.2, 0.2
    for it in range(max_iter):
        tri = triangulate(pts)
        edges = np.unique(
            np.sort(np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]],
                                    tri[:, [2, 0]]]), axis=1), axis=0)
        vec = pts[edges[:, 0]] - pts[edges[:, 1]]
        L = np.linalg.norm(vec, axis=1)
        mid = 0.5 * (pts[edges[:, 0]] + pts[edges[:, 1]])
        hedge = h_field(mid)
        L0 = hedge * Fscale * np.sqrt((L**2).sum() / (hedge**2).sum())
        F = np.maximum(L0 - L, 0.0) / np.maximum(L, 1e-12)
        fvec = F[:, None] * vec
        force = np.zeros_like(pts)
        np.add.at(force, edges[:, 0], fvec)
        np.add.at(force, edges[:, 1], -fvec)
        force[:n_fix] = 0.0  # boundary nodes pinned (exact predicates)
        move = dt * force
        pts = pts + move
        # push escaped interior points back inside
        d = _signed_distance(pts[n_fix:], bnd)
        out = d > -0.2 * h0
        if np.any(out):
            eps = 1e-6
            po = pts[n_fix:][out]
            dgx = (_signed_distance(po + [eps, 0], bnd) - d[out]) / eps
            dgy = (_signed_distance(po + [0, eps], bnd) - d[out]) / eps
            g2 = np.maximum(dgx**2 + dgy**2, 1e-12)
            shift = ((d[out] + 0.5 * h_field(po)) / g2)
            pts[n_fix:][out] -= np.stack([dgx * shift, dgy * shift], axis=1)
        if float(np.max(np.linalg.norm(move[n_fix:], axis=1) / h0,
                        initial=0.0)) < 1e-3:
            break

    # quality cleanup: interior nodes that drifted too close to the pinned
    # boundary create slivers/degenerate triangles (observed: 5 zero-area
    # triangles at full density) — P1 FEM cannot tolerate them.  Drop
    # interior nodes within 0.4·h of the boundary, then iteratively remove
    # the interior vertex of any remaining near-degenerate triangle.
    d_int = _signed_distance(pts[n_fix:], bnd)
    h_int = h_field(pts[n_fix:])
    keep = d_int < -0.4 * h_int
    pts = np.concatenate([pts[:n_fix], pts[n_fix:][keep]])

    for _ in range(20):
        tri = triangulate(pts)
        p = pts[tri]
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        area2 = np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        lmax = np.maximum(
            np.maximum((e1**2).sum(1), (e2**2).sum(1)),
            ((p[:, 2] - p[:, 1]) ** 2).sum(1),
        )
        bad = area2 < 0.02 * lmax  # sliver: height << longest edge
        if not np.any(bad):
            break
        drop = set()
        for t in tri[bad]:
            interior = [v for v in t if v >= n_fix]
            if interior:
                drop.add(max(interior))
        if not drop:
            break  # all-boundary sliver: leave to the FEM's tolerance
        mask = np.ones(len(pts), dtype=bool)
        mask[list(drop)] = False
        pts = pts[mask]

    tri = triangulate(pts)
    # drop unreferenced points (rejected/escaped stragglers)
    used = np.unique(tri)
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return pts[used], remap[tri]


def write_gmsh41(path, nodes: np.ndarray, triangles: np.ndarray) -> None:
    """Minimal gmsh 4.1 ASCII writer (one node block, one triangle block) —
    round-trips through tpinn_torch.oracles.mesh.read_gmsh."""
    n, t = len(nodes), len(triangles)
    with open(path, "w") as f:
        f.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n1 {n} 1 {n}\n2 1 0 {n}\n")
        for i in range(n):
            f.write(f"{i + 1}\n")
        for p in nodes:
            f.write(f"{p[0]:.16g} {p[1]:.16g} 0\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n1 {t} 1 {t}\n2 1 2 {t}\n")
        for i, (a, b, c) in enumerate(triangles):
            f.write(f"{i + 1} {a + 1} {b + 1} {c + 1}\n")
        f.write("$EndElements\n")


def generate_coro_msh(path, prm: CoroGeoParams = CoroGeoParams(),
                      seed: int = 0) -> None:
    """Regenerate coroParam.msh from the geometry parameters (the gmsh-free
    replacement for running gmsh on coroParam.geo)."""
    nodes, tris = mesh_coronary(prm, seed=seed)
    write_gmsh41(path, nodes, tris)
