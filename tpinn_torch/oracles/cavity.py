"""Finite-difference Navier–Stokes solver for the lid-driven cavity.

The "exact" data of the cavity cases: the port's own copy of the JAX
package's oracle, the same arithmetic on PyTorch tensors in float64, on the
CUDA card unless the caller passes ``device="cpu"``.

Method: Chorin projection on a staggered MAC grid (u on vertical faces, v on
horizontal faces, p at cell centres) with

* advection in advective form, a hybrid of central and second-order upwind
  differences (first order where the wide stencil leaves the domain);
* explicit diffusion;
* the pressure Poisson equation (homogeneous Neumann walls, the nullspace
  removed by subtracting means) solved by conjugate gradients warm-started
  from the previous potential.

The conjugate gradients run the JAX package's algorithm in its order of
updates: while r·r > tol²·(b·b) and k < maxiter, α = γ/(p·Ap), x += α·p,
r −= α·Ap, γ′ = r·r, β = γ′/γ, p = r + β·p.  On the card the loop does not
read a flag back after every iteration: it runs ``CG_CHECK`` iterations at a
time, each of them updating the iterate only while the stop test still
fails (a finished solve is frozen with ``torch.where``), and the host reads
the stop flag once per ``CG_CHECK`` iterations.  That gives the iterate of a
loop that stops at the first iteration meeting the test.

Steady solutions march pseudo-time in nondimensional units (Re = U·L/ν);
the unsteady solve is time-accurate with a unit lid; both scale to the
lid-velocity units the cases use (u·U, p·U²).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpinn_torch import config

CG_TOL = 1e-8
CG_MAXITER = 600
CG_CHECK = 8  # conjugate-gradient iterations between two reads of the flag


class MACState(NamedTuple):
    u: torch.Tensor  # (N+1, N)   x-velocity on vertical faces
    v: torch.Tensor  # (N, N+1)   y-velocity on horizontal faces
    p: torch.Tensor  # (N, N)     pressure at cell centres
    phi: torch.Tensor  # (N, N)   previous projection potential (CG warm start)


class CGCounts:
    """What the pressure solves cost: the iterations of each solve (kept on
    the device until ``iterations()`` reads them) and the host reads."""

    def __init__(self):
        self._per_solve: List[torch.Tensor] = []
        self.syncs = 0

    def add(self, k: torch.Tensor) -> None:
        self._per_solve.append(k)

    def iterations(self) -> List[int]:
        if not self._per_solve:
            return []
        self.syncs += 1
        return [int(v) for v in torch.stack(self._per_solve).tolist()]


def _pad_edge_rows(a):
    return torch.cat([a[:1], a, a[-1:]], dim=0)


def _pad_edge_cols(a):
    return torch.cat([a[:, :1], a, a[:, -1:]], dim=1)


def _pad_zero_rows(a):
    z = torch.zeros_like(a[:1])
    return torch.cat([z, a, z], dim=0)


def _pad_zero_cols(a):
    z = torch.zeros_like(a[:, :1])
    return torch.cat([z, a, z], dim=1)


def _laplacian_u(u, lid, h):
    """5-point Laplacian of u with no-slip walls; ghost rows give the
    tangential condition (bottom u = 0, top u = lid)."""
    u_pad_y = torch.cat([(2.0 * 0.0 - u[:, :1]), u, (2.0 * lid - u[:, -1:])],
                        dim=1)
    d2y = (u_pad_y[:, 2:] - 2.0 * u_pad_y[:, 1:-1] + u_pad_y[:, :-2]) / h ** 2
    u_pad_x = _pad_zero_rows(u)  # values beyond the walls are not used
    d2x = (u_pad_x[2:] - 2.0 * u_pad_x[1:-1] + u_pad_x[:-2]) / h ** 2
    return d2x + d2y


def _laplacian_v(v, h):
    v_pad_x = torch.cat([(-v[:1, :]), v, (-v[-1:, :])], dim=0)
    d2x = (v_pad_x[2:] - 2.0 * v_pad_x[1:-1] + v_pad_x[:-2]) / h ** 2
    v_pad_y = _pad_zero_cols(v)
    d2y = (v_pad_y[:, 2:] - 2.0 * v_pad_y[:, 1:-1] + v_pad_y[:, :-2]) / h ** 2
    return d2x + d2y


def _upwind2_pair(c, m1, m2, p1, p2, h, valid_m2, valid_p2):
    """Second-order one-sided (backward, forward) derivatives at the points
    of ``c``, first order where the wide stencil leaves the domain."""
    b2 = (3.0 * c - 4.0 * m1 + m2) / (2.0 * h)
    b1 = (c - m1) / h
    f2 = (-3.0 * c + 4.0 * p1 - p2) / (2.0 * h)
    f1 = (p1 - c) / h
    return torch.where(valid_m2, b2, b1), torch.where(valid_p2, f2, f1)


def _advect_u(u, v, lid, h, upwind: float):
    """(U·∇)u at the interior u-faces."""
    N1, N = u.shape
    u_g = torch.cat([(0.0 - u[:, :1]), u, (2.0 * lid - u[:, -1:])], dim=1)
    dudx_c = (u[2:, :] - u[:-2, :]) / (2 * h)
    ii = torch.arange(1, N1 - 1, device=u.device)[:, None]
    dudx_m, dudx_p = _upwind2_pair(
        u[1:-1, :], u[:-2, :],
        torch.cat([u[:1, :], u[:-3, :]], dim=0),
        u[2:, :],
        torch.cat([u[3:, :], u[-1:, :]], dim=0),
        h, ii >= 2, ii <= N1 - 3)
    dudy_c_full = (u_g[:, 2:] - u_g[:, :-2]) / (2 * h)
    jj = torch.arange(N, device=u.device)[None, :]
    dudy_m_full, dudy_p_full = _upwind2_pair(
        u, u_g[:, :-2],
        torch.cat([u_g[:, :1], u_g[:, :N - 1]], dim=1),
        u_g[:, 2:],
        torch.cat([u_g[:, 3:], u_g[:, -1:]], dim=1),
        h, jj >= 1, jj <= N - 2)
    dudy_c = dudy_c_full[1:-1, :]
    dudy_m = dudy_m_full[1:-1, :]
    dudy_p = dudy_p_full[1:-1, :]

    uc = u[1:-1, :]
    v_at_u = 0.25 * (v[:-1, :-1] + v[1:, :-1] + v[:-1, 1:] + v[1:, 1:])
    dudx_up = torch.where(uc > 0, dudx_m, dudx_p)
    dudy_up = torch.where(v_at_u > 0, dudy_m, dudy_p)
    dudx = (1 - upwind) * dudx_c + upwind * dudx_up
    dudy = (1 - upwind) * dudy_c + upwind * dudy_up
    return uc * dudx + v_at_u * dudy


def _advect_v(u, v, h, upwind: float):
    N, N1 = v.shape
    v_g = torch.cat([(-v[:1, :]), v, (-v[-1:, :])], dim=0)
    dvdy_c = (v[:, 2:] - v[:, :-2]) / (2 * h)
    jj = torch.arange(1, N1 - 1, device=v.device)[None, :]
    dvdy_m, dvdy_p = _upwind2_pair(
        v[:, 1:-1], v[:, :-2],
        torch.cat([v[:, :1], v[:, :-3]], dim=1),
        v[:, 2:],
        torch.cat([v[:, 3:], v[:, -1:]], dim=1),
        h, jj >= 2, jj <= N1 - 3)
    dvdx_c_full = (v_g[2:, :] - v_g[:-2, :]) / (2 * h)
    ii = torch.arange(N, device=v.device)[:, None]
    dvdx_m_full, dvdx_p_full = _upwind2_pair(
        v, v_g[:-2, :],
        torch.cat([v_g[:1, :], v_g[:N - 1, :]], dim=0),
        v_g[2:, :],
        torch.cat([v_g[3:, :], v_g[-1:, :]], dim=0),
        h, ii >= 1, ii <= N - 2)
    dvdx_c = dvdx_c_full[:, 1:-1]
    dvdx_m = dvdx_m_full[:, 1:-1]
    dvdx_p = dvdx_p_full[:, 1:-1]

    vc = v[:, 1:-1]
    u_at_v = 0.25 * (u[:-1, :-1] + u[1:, :-1] + u[:-1, 1:] + u[1:, 1:])
    dvdx_up = torch.where(u_at_v > 0, dvdx_m, dvdx_p)
    dvdy_up = torch.where(vc > 0, dvdy_m, dvdy_p)
    dvdx = (1 - upwind) * dvdx_c + upwind * dvdx_up
    dvdy = (1 - upwind) * dvdy_c + upwind * dvdy_up
    return u_at_v * dvdx + vc * dvdy


def _divergence(u, v, h):
    return (u[1:, :] - u[:-1, :]) / h + (v[:, 1:] - v[:, :-1]) / h


def _poisson_neumann_op(phi, h):
    """Cell-centred Laplacian with homogeneous Neumann walls."""
    phi_x = _pad_edge_rows(phi)
    phi_y = _pad_edge_cols(phi)
    return ((phi_x[2:] - 2 * phi_x[1:-1] + phi_x[:-2])
            + (phi_y[:, 2:] - 2 * phi_y[:, 1:-1] + phi_y[:, :-2])) / h ** 2


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg(op, b, x0, tol: float = CG_TOL, maxiter: int = CG_MAXITER,
       counts: Optional[CGCounts] = None):
    """Conjugate gradients on ``op`` from ``x0``, stopping as the JAX
    package's (``jax.scipy.sparse.linalg.cg``) does: before iteration k while
    r·r > tol²·(b·b) and k < maxiter.  The operator may be negative
    semi-definite (α and the update order make no use of the sign).  The
    host reads the stop flag once per ``CG_CHECK`` iterations."""
    atol2 = torch.clamp_min((tol * tol) * _vdot(b, b), 0.0)
    x = x0
    r = b - op(x0)
    p = r
    gamma = _vdot(r, r)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for it in range(maxiter):
        active = (gamma > atol2) & (k < maxiter)
        if it % CG_CHECK == 0:
            if counts is not None:
                counts.syncs += 1
            if not bool(active):
                break
        ap = op(p)
        alpha = torch.where(active, gamma / _vdot(p, ap), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        gamma_new = _vdot(r, r)
        p = torch.where(active, r + (gamma_new / gamma) * p, p)
        gamma = torch.where(active, gamma_new, gamma)
        k = k + active
    if counts is not None:
        counts.add(k)
    return x


def _solve_pressure(rhs, h, x0, counts: Optional[CGCounts] = None):
    rhs = rhs - torch.mean(rhs)  # compatibility with the Neumann nullspace
    phi = cg(lambda q: _poisson_neumann_op(q, h), rhs, x0, counts=counts)
    return phi - torch.mean(phi)


def _project(u, v, phi, h, dt):
    dphidx = (phi[1:, :] - phi[:-1, :]) / h
    dphidy = (phi[:, 1:] - phi[:, :-1]) / h
    u = torch.cat([u[:1], u[1:-1] + -dt * dphidx, u[-1:]], dim=0)
    v = torch.cat([v[:, :1], v[:, 1:-1] + -dt * dphidy, v[:, -1:]], dim=1)
    return u, v


def _step(state: MACState, re, lid, h, dt, upwind,
          counts: Optional[CGCounts] = None) -> MACState:
    u, v, _, phi_prev = state
    adv_u = _advect_u(u, v, lid, h, upwind)
    adv_v = _advect_v(u, v, h, upwind)
    lap_u = _laplacian_u(u, lid, h)[1:-1, :]
    lap_v = _laplacian_v(v, h)[:, 1:-1]
    # the normal components on the walls are 0
    zr, zc = torch.zeros_like(u[:1]), torch.zeros_like(v[:, :1])
    u_star = torch.cat([zr, u[1:-1, :] + dt * (-adv_u + lap_u / re), zr],
                       dim=0)
    v_star = torch.cat([zc, v[:, 1:-1] + dt * (-adv_v + lap_v / re), zc],
                       dim=1)
    rhs = _divergence(u_star, v_star, h) / dt
    phi = _solve_pressure(rhs, h, phi_prev, counts)
    u_new, v_new = _project(u_star, v_star, phi, h, dt)
    # non-incremental Chorin: u_star has no pressure gradient, so phi is
    # the whole pressure at the new time level
    return MACState(u_new, v_new, phi, phi)


def _vertex_fields(state: MACState, lid) -> Tuple[torch.Tensor, ...]:
    """The MAC fields on the (N+1)² vertex grid, flattened x fastest."""
    u, v, p = state.u, state.v, state.p
    u_vert = torch.cat([torch.zeros_like(u[:, :1]),
                        0.5 * (u[:, 1:] + u[:, :-1]),
                        torch.full_like(u[:, :1], lid)], dim=1)
    u_vert[0, :] = 0.0
    u_vert[-1, :] = 0.0
    v_vert = torch.cat([torch.zeros_like(v[:1, :]),
                        0.5 * (v[1:, :] + v[:-1, :]),
                        torch.zeros_like(v[:1, :])], dim=0)
    v_vert[:, 0] = 0.0
    v_vert[:, -1] = 0.0
    # p at a vertex: the mean of its 4 cells (edges: 2, corners: 1)
    p_pad = _pad_edge_cols(_pad_edge_rows(p))
    p_vert = 0.25 * (p_pad[:-1, :-1] + p_pad[1:, :-1] + p_pad[:-1, 1:]
                     + p_pad[1:, 1:])
    return u_vert.T.reshape(-1), v_vert.T.reshape(-1), p_vert.T.reshape(-1)


def _zero_state(n: int, dtype, device) -> MACState:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return MACState(z(n + 1, n), z(n, n + 1), z(n, n), z(n, n))


def solve_cavity_steady(re: float = 500.0, n: int = 128,
                        lid_velocity: float = 1.0, dt: Optional[float] = None,
                        t_end: float = 40.0, upwind: Optional[float] = None,
                        tol: float = 1e-6, dtype=torch.float64, device=None,
                        counts: Optional[CGCounts] = None):
    """Steady lid-driven cavity at Reynolds number ``re`` by pseudo-time
    marching to ``t_end`` (in blocks of 50 steps, as the JAX package).

    Returns (u, v, p) as numpy arrays on the (n+1)² vertex grid, x fastest,
    in lid-velocity units.  ``tol`` is accepted for the JAX package's
    signature and not used, as there; ``counts`` collects the pressure
    solves' iterations."""
    device = config.resolve_device(device)
    h = 1.0 / n
    if dt is None:
        dt = 0.4 * min(h, 0.25 * h * h * re)
    if upwind is None:
        cell_pe = re * h
        upwind = (float(np.clip((cell_pe - 1.5) / cell_pe, 0.0, 0.35))
                  if cell_pe > 1.5 else 0.0)
    inner = 50
    steps = int(t_end / dt / inner) + 1
    state = _zero_state(n, dtype, device)
    for _ in range(steps * inner):
        state = _step(state, re, 1.0, h, dt, upwind, counts)
    u, v, p = (f.cpu().numpy() for f in _vertex_fields(state, 1.0))
    scale = lid_velocity
    return u * scale, v * scale, p * scale * scale


def solve_cavity_unsteady(nu: float = 1.0, lid_velocity: float = 1.0,
                          t_end: float = 1e-2, dt_out: float = 1e-4,
                          n: int = 100, substeps: Optional[int] = None,
                          dtype=torch.float64, device=None,
                          counts: Optional[CGCounts] = None):
    """The impulsively started cavity, time-accurate (unit lid, Re = U/ν).

    Returns (times, snapshots): the output times t = 0, dt_out, …,
    t_end − dt_out and one (u, v, p) tuple of numpy vertex fields per time;
    the t = 0 snapshot is the zero field (the lid not yet moving).  Each
    output interval takes ``substeps`` explicit steps (by default the fewest
    that keep diffusion stable).  The snapshots stay on the device until the
    end and come back in one copy."""
    device = config.resolve_device(device)
    h = 1.0 / n
    re_eff = lid_velocity / nu
    dt_stable = 0.2 * h * h * re_eff
    if substeps is None:
        substeps = max(1, int(np.ceil(dt_out / dt_stable)))
    dt = dt_out / substeps
    state = _zero_state(n, dtype, device)
    n_out = int(round(t_end / dt_out))
    times, snaps = [], []
    for it in range(n_out):
        times.append(it * dt_out)
        snaps.append(torch.stack(_vertex_fields(state,
                                                0.0 if it == 0 else 1.0)))
        for _ in range(substeps):
            state = _step(state, re_eff, 1.0, h, dt, 0.0, counts)
    if counts is not None:
        counts.syncs += 1
    host = torch.stack(snaps).cpu().numpy()
    scale = (lid_velocity, lid_velocity, lid_velocity * lid_velocity)
    return np.asarray(times), [tuple(s[c] * scale[c] for c in range(3))
                               for s in host]


def vertex_grid(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (n+1)² vertex coordinates, x fastest (the drivers' grid order)."""
    xs = np.linspace(0.0, 1.0, n + 1)
    ys = np.linspace(0.0, 1.0, n + 1)
    xx, yy = np.meshgrid(xs, ys)
    return xx.reshape(-1), yy.reshape(-1)


def interpolate_vertex_field(field_flat, n: int, xq, yq):
    """Bilinear interpolation of a vertex field to query points in [0, 1]²."""
    f = np.asarray(field_flat).reshape(n + 1, n + 1)  # [j, i] = (y_j, x_i)
    x = np.clip(np.asarray(xq), 0.0, 1.0) * n
    y = np.clip(np.asarray(yq), 0.0, 1.0) * n
    i0 = np.clip(x.astype(int), 0, n - 1)
    j0 = np.clip(y.astype(int), 0, n - 1)
    fx = x - i0
    fy = y - j0
    return (f[j0, i0] * (1 - fx) * (1 - fy)
            + f[j0, i0 + 1] * fx * (1 - fy)
            + f[j0 + 1, i0] * (1 - fx) * fy
            + f[j0 + 1, i0 + 1] * fx * fy)
