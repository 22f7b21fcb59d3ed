"""P1-P1 stabilized finite-element Navier-Stokes solvers on triangle meshes,
the coronary oracle's L0 stage (numpy assembly, scipy's sparse direct
solver on the host).

Formulation: equal-order P1 velocity and pressure with Brezzi-Pitkaranta
stabilization (-alpha sum_T h_T^2 (grad p, grad q)_T) for inf-sup; steady
convection by Picard iteration, unsteady by a semi-implicit (or Picard
converged, or convection-free) step per time step; outflow by the
do-nothing natural condition, optionally with the (p/nu)(n.v) surface term
on given boundary edges.  The operations are tpinn's (tpinn/oracles/fem.py)
in the same order, so the fields equal the JAX package's oracle's bit for
bit on the same host.  scipy is imported inside the functions that build
or solve a sparse system: importing the port loads no scipy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _coo(vals, rows, cols, shape):
    """The csr matrix of the (row, col, value) triplets, duplicates
    summed."""
    import scipy.sparse as sp

    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


def _spsolve(A, b):
    import scipy.sparse.linalg as spla

    return spla.spsolve(A, b)


def _bmat(blocks):
    import scipy.sparse as sp

    return sp.bmat(blocks, format="lil")


def _triangle_geometry(nodes: np.ndarray, tris: np.ndarray):
    """Per-triangle areas and P1 basis gradients.

    Returns (area (T,), grads (T, 3, 2)) with grads[t, a] = ∇λ_a on tri t.
    """
    p0 = nodes[tris[:, 0]]
    p1 = nodes[tris[:, 1]]
    p2 = nodes[tris[:, 2]]
    d1 = p1 - p0
    d2 = p2 - p0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * np.abs(det)
    # gradients of barycentric coordinates
    inv_det = 1.0 / det
    b = np.empty((len(tris), 3, 2))
    b[:, 1, 0] = d2[:, 1] * inv_det
    b[:, 1, 1] = -d2[:, 0] * inv_det
    b[:, 2, 0] = -d1[:, 1] * inv_det
    b[:, 2, 1] = d1[:, 0] * inv_det
    b[:, 0] = -b[:, 1] - b[:, 2]
    return area, b


def _assemble_stiffness(nodes, tris, area, grads):
    """K_ij = ∫ ∇φ_i · ∇φ_j."""
    T = len(tris)
    rows = np.repeat(tris, 3, axis=1).reshape(T, 9)
    cols = np.tile(tris, (1, 3)).reshape(T, 9)
    ke = np.einsum("tad,tbd->tab", grads, grads) * area[:, None, None]
    vals = ke.transpose(0, 2, 1).reshape(T, 9)
    M = len(nodes)
    return _coo(vals.ravel(), rows.ravel(), cols.ravel(), (M, M))


def _assemble_divergence(nodes, tris, area, grads):
    """B(d)_ij = ∫ φ_i ∂φ_j/∂x_d  (pressure-test × velocity-trial)."""
    T = len(tris)
    M = len(nodes)
    rows = np.repeat(tris, 3, axis=1).reshape(T, 9)
    cols = np.tile(tris, (1, 3)).reshape(T, 9)
    third = area / 3.0
    out = []
    for d in range(2):
        # ∫_T φ_a ∂φ_b/∂x_d = (area/3) ∂φ_b/∂x_d  (P1: gradient constant)
        be = third[:, None, None] * np.broadcast_to(
            grads[:, None, :, d], (T, 3, 3)
        )
        vals = be.reshape(T, 9)
        out.append(
            _coo(vals.ravel(), rows.ravel(), cols.ravel(), (M, M))
        )
    return out[0], out[1]


def _assemble_mass_lumped(nodes, tris, area) -> np.ndarray:
    M = np.zeros(len(nodes))
    for a in range(3):
        np.add.at(M, tris[:, a], area / 3.0)
    return M


def _assemble_convection(nodes, tris, area, grads, u, v):
    """N(w)_ij = ∫ (w·∇φ_j) φ_i with w the current velocity (Picard).

    One-point quadrature at the centroid: w̄ = mean of nodal values.
    """
    T = len(tris)
    M = len(nodes)
    wu = u[tris].mean(axis=1)
    wv = v[tris].mean(axis=1)
    # (w̄ · ∇φ_b) is constant per triangle; ∫_T φ_a = area/3
    conv = wu[:, None] * grads[:, :, 0] + wv[:, None] * grads[:, :, 1]  # (T,3)
    ne = (area / 3.0)[:, None, None] * np.broadcast_to(
        conv[:, None, :], (T, 3, 3)
    )
    rows = np.repeat(tris, 3, axis=1).reshape(T, 9)
    cols = np.tile(tris, (1, 3)).reshape(T, 9)
    return _coo(ne.reshape(T, 9).ravel(), rows.ravel(), cols.ravel(), (M, M))


def solve_stokes(
    nodes: np.ndarray,
    tris: np.ndarray,
    nu: float,
    dirichlet: Dict[int, Tuple[float, float]],
    alpha_stab: float = 0.05,
):
    """Linear Stokes solve (the reference FEM stage's 'stokes' formulation
    option, fluid_solver_steady.py:64-72): ν(∇u,∇v) − (∇·v)p + q(∇·u) = 0
    with the same P1–P1 stabilized discretization.  With a zero initial
    state the first Picard iteration has no convection, so one iteration of
    the NS solver IS the Stokes solve."""
    return solve_navier_stokes(
        nodes, tris, nu=nu, dirichlet=dirichlet, alpha_stab=alpha_stab,
        picard_iters=1,
    )


def _assemble_mass_consistent(nodes, tris, area):
    """M_ij = ∫ φ_i φ_j (P1 consistent mass: area/12 · (1 + δ_ab))."""
    T = len(tris)
    M = len(nodes)
    me = (area / 12.0)[:, None, None] * (
        np.ones((3, 3)) + np.eye(3)
    )[None, :, :]
    rows = np.repeat(tris, 3, axis=1).reshape(T, 9)
    cols = np.tile(tris, (1, 3)).reshape(T, 9)
    return _coo(me.reshape(T, 9).ravel(), rows.ravel(), cols.ravel(), (M, M))


def boundary_edges_with_normals(nodes: np.ndarray, tris: np.ndarray):
    """Boundary edges with outward unit normals and lengths.

    Returns (edges (E, 2) node pairs, normals (E, 2), lengths (E,)).  The
    normal of an edge owned by one triangle points away from that triangle's
    opposite vertex.
    """
    edge_list = np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0
    )
    opposite = np.concatenate([tris[:, 2], tris[:, 0], tris[:, 1]], axis=0)
    key = np.sort(edge_list, axis=1)
    uniq, first, counts = np.unique(
        key, axis=0, return_index=True, return_counts=True
    )
    sel = first[counts == 1]
    edges = edge_list[sel]
    opp = opposite[sel]
    tang = nodes[edges[:, 1]] - nodes[edges[:, 0]]
    lengths = np.linalg.norm(tang, axis=1)
    normals = np.stack([tang[:, 1], -tang[:, 0]], axis=1) / lengths[:, None]
    mid = 0.5 * (nodes[edges[:, 0]] + nodes[edges[:, 1]])
    flip = np.einsum("ed,ed->e", normals, mid - nodes[opp]) < 0
    normals[flip] *= -1.0
    return edges, normals, lengths


def _assemble_boundary_pressure_coupling(n_nodes, edges, normals, lengths):
    """S(d)_ij = ∫_Γ φ_i φ_j n_d ds over the given boundary edges.

    The reference's unsteady coronary form adds (p/ν)(n·v) surface terms on
    the outflow boundaries (DataGeneration/coronary.py:123); per P1 edge the
    mass is L/6 · [[2,1],[1,2]] scaled by the edge normal component."""
    E = len(edges)
    base = np.array([[2.0, 1.0], [1.0, 2.0]]) / 6.0
    rows = np.repeat(edges, 2, axis=1).reshape(E, 4)
    cols = np.tile(edges, (1, 2)).reshape(E, 4)
    out = []
    for d in range(2):
        se = base[None, :, :] * (lengths * normals[:, d])[:, None, None]
        out.append(
            _coo(se.reshape(E, 4).ravel(), rows.ravel(), cols.ravel(), (n_nodes, n_nodes))
        )
    return out[0], out[1]


def solve_navier_stokes_unsteady(
    nodes: np.ndarray,
    tris: np.ndarray,
    nu: float,
    dirichlet: Dict[int, Tuple[float, float]],
    t_end: float,
    dt: float,
    pressure_outflow_edges: Optional[np.ndarray] = None,
    alpha_stab: float = 0.05,
    formulation: str = "navier-stokes_SI",
    inner_iters: int = 12,
    inner_tol: float = 1e-10,
    verbose: bool = False,
):
    """Unsteady incompressible NS in the reference's three formulations
    (fluid_solver_unsteady.py:110-150, DataGeneration/coronary.py:110-130):

    * ``'navier-stokes_SI'`` (default) — semi-implicit: convection frozen
      at u_old, one LINEAR solve per step
    * ``'stokes'`` — no convection term
    * ``'navier-stokes_I'`` — fully implicit: the convection is converged
      by Picard sub-iterations per step (the fixed point equals the
      reference's Newton solve to ``inner_tol``)

    The semi-implicit step solves the LINEAR system

        (u, v)/dt + ν(∇u, ∇v) + ((∇u)·u_old, v) − (∇·v) p + q (∇·u)
          + (p/ν)(n·v) over the outflow boundary  =  (u_old, v)/dt

    with P1–P1 Brezzi–Pitkäranta stabilization on the continuity equation.
    ``pressure_outflow_edges``: (E, 2) boundary-edge node pairs carrying the
    (p/ν)(n·v) surface term (the reference's ds(2) + ds(3) outflows); the
    rest of the non-Dirichlet boundary is natural (do-nothing).

    Caveat inherited from the reference formulation: at ν = 1 the (p/ν) n·v
    surface term exactly cancels the natural −p n·v outflow flux, leaving
    the constant-pressure mode unconstrained (singular system).  The
    coronary case runs at ν ≈ 94.3 where the cancellation is partial and
    the system is well-posed; avoid ν = 1 with this term enabled.

    Returns (times, snaps) with times[0] = 0 (zero initial state, as the
    reference's unsaved ``w`` initializes) and one nodal (u, v, p) per step.
    """
    M = len(nodes)
    area, grads = _triangle_geometry(nodes, tris)
    K = _assemble_stiffness(nodes, tris, area, grads)
    Bx, By = _assemble_divergence(nodes, tris, area, grads)
    Mc = _assemble_mass_consistent(nodes, tris, area)
    hT2 = 2.0 * area
    T = len(tris)
    rows = np.repeat(tris, 3, axis=1).reshape(T, 9)
    cols = np.tile(tris, (1, 3)).reshape(T, 9)
    ce = (
        np.einsum("tad,tbd->tab", grads, grads)
        * (alpha_stab * hT2 * area)[:, None, None]
    )
    C = _coo(ce.transpose(0, 2, 1).reshape(T, 9).ravel(), rows.ravel(), cols.ravel(), (M, M))

    if pressure_outflow_edges is not None and len(pressure_outflow_edges):
        all_edges, all_normals, all_lengths = boundary_edges_with_normals(
            nodes, tris
        )
        keys = {tuple(sorted(e)) for e in np.asarray(pressure_outflow_edges)}
        sel = np.array(
            [tuple(sorted(e)) in keys for e in all_edges], dtype=bool
        )
        Sx, Sy = _assemble_boundary_pressure_coupling(
            M, all_edges[sel], all_normals[sel], all_lengths[sel]
        )
        Px = -Bx.T + Sx / nu
        Py = -By.T + Sy / nu
    else:
        Px, Py = -Bx.T, -By.T

    dir_idx = np.fromiter(dirichlet.keys(), dtype=np.int64)
    dir_u = np.array([dirichlet[i][0] for i in dir_idx])
    dir_v = np.array([dirichlet[i][1] for i in dir_idx])

    u = np.zeros(M)
    v = np.zeros(M)
    p = np.zeros(M)
    # reference initial state: w = 0 except Dirichlet values enter through
    # the first solve's boundary rows
    if formulation not in ("navier-stokes_SI", "stokes", "navier-stokes_I"):
        raise ValueError(f"unknown formulation {formulation!r}")

    def _linear_step(u_conv, v_conv, u_old, v_old):
        """One linear solve with convection frozen at (u_conv, v_conv)."""
        if formulation == "stokes":
            A = Mc / dt + nu * K
        else:
            N = _assemble_convection(nodes, tris, area, grads, u_conv, v_conv)
            A = Mc / dt + nu * K + N
        sys = _bmat([[A, None, Px], [None, A, Py], [Bx, By, C]])
        rhs = np.zeros(3 * M)
        rhs[:M] = Mc @ u_old / dt
        rhs[M: 2 * M] = Mc @ v_old / dt
        for r, val in zip(dir_idx, dir_u):
            sys.rows[r] = [r]
            sys.data[r] = [1.0]
            rhs[r] = val
        for r0, val in zip(dir_idx, dir_v):
            r = r0 + M
            sys.rows[r] = [r]
            sys.data[r] = [1.0]
            rhs[r] = val
        sol = _spsolve(sys.tocsr(), rhs)
        return sol[:M], sol[M: 2 * M], sol[2 * M:]

    times = np.arange(0.0, t_end, step=dt)
    snaps = [(u.copy(), v.copy(), p.copy())]
    for i, t in enumerate(times[1:], start=1):
        if formulation == "navier-stokes_I":
            u_old, v_old = u, v
            uk, vk = u, v
            for k in range(inner_iters):
                u_new, v_new, p = _linear_step(uk, vk, u_old, v_old)
                delta = max(np.max(np.abs(u_new - uk)),
                            np.max(np.abs(v_new - vk)))
                uk, vk = u_new, v_new
                if delta < inner_tol * max(1e-12, np.max(np.abs(u_new))):
                    break
            u, v = uk, vk
        else:
            u, v, p = _linear_step(u, v, u, v)
        if verbose:
            print(f"  t = {t:.6f}: max|u| {np.max(np.abs(u)):.4f}")
        snaps.append((u.copy(), v.copy(), p.copy()))
    return times, snaps


def solve_navier_stokes(
    nodes: np.ndarray,
    tris: np.ndarray,
    nu: float,
    dirichlet: Dict[int, Tuple[float, float]],
    alpha_stab: float = 0.05,
    picard_iters: int = 25,
    picard_tol: float = 1e-8,
    verbose: bool = False,
    counts: Optional[dict] = None,
):
    """Steady incompressible NS; returns nodal (u, v, p).

    ``dirichlet``: {node_index: (u, v)}.  Non-Dirichlet boundary segments get
    the do-nothing outflow condition ν∂u/∂n − p n = 0 naturally.  Picard
    iterates until the relative change of the velocity falls below
    ``picard_tol`` or ``picard_iters`` solves; ``counts["picard"]`` gets
    the number of solves.
    """
    M = len(nodes)
    area, grads = _triangle_geometry(nodes, tris)
    K = _assemble_stiffness(nodes, tris, area, grads)
    Bx, By = _assemble_divergence(nodes, tris, area, grads)
    # Brezzi–Pitkäranta: C = α Σ_T h_T² (∇p, ∇q)_T
    hT2 = 2.0 * area  # h_T² ≈ 2·area for roughly isotropic triangles
    T = len(tris)
    rows = np.repeat(tris, 3, axis=1).reshape(T, 9)
    cols = np.tile(tris, (1, 3)).reshape(T, 9)
    ce = (
        np.einsum("tad,tbd->tab", grads, grads)
        * (alpha_stab * hT2 * area)[:, None, None]
    )
    C = _coo(ce.transpose(0, 2, 1).reshape(T, 9).ravel(), rows.ravel(), cols.ravel(), (M, M))

    dir_idx = np.fromiter(dirichlet.keys(), dtype=np.int64)
    dir_u = np.array([dirichlet[i][0] for i in dir_idx])
    dir_v = np.array([dirichlet[i][1] for i in dir_idx])

    u = np.zeros(M)
    v = np.zeros(M)
    u[dir_idx] = dir_u
    v[dir_idx] = dir_v
    p = np.zeros(M)

    n_u = M
    for it in range(picard_iters):
        N = _assemble_convection(nodes, tris, area, grads, u, v)
        A = nu * K + N
        # weak form: a(u,v) − (p, ∇·v) = 0 ; (∇·u, q) + α h²(∇p, ∇q) = 0
        # momentum pressure block: −(p, ∂φ_i/∂x_d) = −B(d)^T
        sys = _bmat([[A, None, -Bx.T], [None, A, -By.T], [Bx, By, C]])
        rhs = np.zeros(3 * M)
        # Dirichlet rows for u and v blocks
        sys_rows_u = dir_idx
        sys_rows_v = dir_idx + n_u
        for rows_set, vals in ((sys_rows_u, dir_u), (sys_rows_v, dir_v)):
            for r, val in zip(rows_set, vals):
                sys.rows[r] = [r]
                sys.data[r] = [1.0]
                rhs[r] = val
        sol = _spsolve(sys.tocsr(), rhs)
        u_new, v_new, p_new = sol[:M], sol[M : 2 * M], sol[2 * M :]
        du = max(
            np.max(np.abs(u_new - u)), np.max(np.abs(v_new - v))
        ) / max(1e-12, np.max(np.abs(u_new)))
        u, v, p = u_new, v_new, p_new
        if verbose:
            print(f"  picard {it}: rel delta {du:.2e}")
        if counts is not None:
            counts["picard"] = it + 1
        if du < picard_tol:
            break
    return u, v, p
