"""Poiseuille_Flow, plainly: the inputs a seed makes, and the training loss
with its parameter gradients.

Steady Navier-Stokes in the 1 x 0.1 channel of the published example,
rho = 3100, mu = 890, a 1e6 Pa drop: the fields u, v, p of a tanh MLP in
spread-normalized units (U = nv u, P = np p), the mass and momentum
residuals at the PDE points (momentum rescaled by 1 / max(np, nv)),
Dirichlet walls and parabolic inflow, traction outflow, and the velocity
fit points:

    loss = 10 mean(mass^2) + mean(mom_u^2) + mean(mom_v^2)
           + sum over the 8 boundary losses of mean(r^2)
           + mean(fit_u^2) + mean(fit_v^2).

The PDE points are summed in blocks, so that 4M points fit beside the
graphs of the autograd derivatives.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from benchmark.reference import mlp

EDGES = ("BOT", "DX", "TOP", "SX")
DIRICHLET = ("BOT", "TOP", "SX")  # DX carries the traction (Neumann) losses


def exact(x: torch.Tensor, cfg: dict):
    """(u, v, p): plane Poiseuille flow with the configuration's lava."""
    dp = cfg["p_out"] - cfg["p_in"]
    d = cfg["half_height"]
    u = -dp * x[:, 1] * (2.0 - x[:, 1] / d) * d / (2.0 * cfg["mu"])
    v = 0.0 * x[:, 0]
    p = dp / cfg["length"] * x[:, 0] + cfg["p_in"]
    return u, v, p


def _box(generator, n, lo, hi):
    lo = torch.tensor(lo, dtype=torch.float64)
    hi = torch.tensor(hi, dtype=torch.float64)
    return lo + torch.rand(n, lo.shape[0], generator=generator,
                           dtype=torch.float64) * (hi - lo)


def make_inputs(cfg: dict, seed: int, ranks: int = 1) -> dict:
    """Every input of a run from ``seed``: the points (``n_pde`` per rank,
    then the fit and the test points), the index splits, the boundary
    points per edge, the boundary values and fit targets that the exact
    solution gives, and the initial weights.  numpy arrays on the host."""
    s_pts, s_bnd, s_par = mlp.seeds(seed, 3)
    g = torch.Generator().manual_seed(s_pts)
    (lx, ux), (ly, uy) = cfg["extents"]
    n = cfg["n_pde"] * ranks
    n_vel, n_test = cfg["n_vel"], cfg["n_test"]
    grid = _box(g, n + n_vel + n_test, [lx, ly], [ux, uy])
    idx = {"PDE": np.arange(n), "Vel": np.arange(n, n + n_vel),
           "Pres": np.arange(0), "Test": np.arange(n + n_vel,
                                                    n + n_vel + n_test)}
    g = torch.Generator().manual_seed(s_bnd)
    corners = {"BOT": ([lx, ly], [ux, ly]), "DX": ([ux, ly], [ux, uy]),
               "TOP": ([lx, uy], [ux, uy]), "SX": ([lx, ly], [lx, uy])}
    bnd = {e: _box(g, cfg["n_bc"], *corners[e]) for e in EDGES}
    nv, npre = normalization(grid, cfg)
    u_sx = exact(bnd["SX"], cfg)[0] / nv
    zeros = lambda e: torch.zeros(cfg["n_bc"], dtype=torch.float64)
    # Dirichlet values are normalized; the outlet traction is physical
    # (p_out for u, 0 for v)
    bnd_val = {0: {"BOT": zeros("BOT"), "TOP": zeros("TOP"), "SX": u_sx,
                   "DX": zeros("DX") + cfg["p_out"]},
               1: {e: zeros(e) for e in ("BOT", "TOP", "SX", "DX")}}
    u, v, _ = exact(grid[idx["Vel"]], cfg)
    g = torch.Generator().manual_seed(s_par)
    return {
        "dom_grid": grid.numpy(), "idx_set": idx,
        "bnd_pts": {e: t.numpy() for e, t in bnd.items()},
        "bnd_val_num": {c: {e: t.numpy() for e, t in d.items()}
                        for c, d in bnd_val.items()},
        "sol_noise": [(u / nv).numpy(), (v / nv).numpy(),
                      np.zeros(0)],
        "params": mlp.init_params(cfg["layers"], cfg["extents"], g),
        "n_pde_total": n,
    }


def normalization(grid: torch.Tensor, cfg: dict):
    """(nv, np): the spread of the exact velocity and pressure over every
    point of the run (1 where a spread is 0)."""
    u, v, p = exact(grid, cfg)
    spread = lambda a: float(a.max() - a.min())
    return (max(spread(u), spread(v)) or 1.0), (spread(p) or 1.0)


class Objective:
    """The training loss of ``inputs`` and its gradients in ``dtype`` on
    ``device``.  Planted faults: ``n_rows`` keeps the first rows of the PDE
    batch alone, and ``n_mean`` divides their sum by another count than
    theirs (one rank's share without the exchange between ranks)."""

    def __init__(self, cfg: dict, inputs: dict, device, dtype=torch.float64,
                 n_rows: Optional[int] = None, n_mean: Optional[int] = None):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        grid = torch.as_tensor(inputs["dom_grid"])
        self.nv, self.npre = normalization(grid, cfg)
        self.rs = 1.0 / max(self.nv, self.npre)
        t = lambda a: torch.as_tensor(np.asarray(a)).to(device=device,
                                                        dtype=dtype)
        n = inputs["n_pde_total"] if n_rows is None else int(n_rows)
        self.x_pde = t(grid[inputs["idx_set"]["PDE"][:n]])
        self.n_mean = n if n_mean is None else int(n_mean)
        self.block = int(cfg["ref_block"])
        self.bnd = {e: t(a) for e, a in inputs["bnd_pts"].items()}
        self.bnd_val = {c: {e: t(a) for e, a in d.items()}
                        for c, d in inputs["bnd_val_num"].items()}
        self.x_vel = t(grid[inputs["idx_set"]["Vel"]])
        self.fit = [t(a) for a in inputs["sol_noise"][:2]]
        self.w = cfg["weights"]

    def _pde_sums(self, params, x):
        out, jac, hd = mlp.derivatives(params, x, second=(0, 1))
        nv, npre, rho, mu = self.nv, self.npre, self.cfg["rho"], self.cfg["mu"]
        mass = jac[0][:, 0] + jac[1][:, 1]
        U, V = nv * out[:, 0], nv * out[:, 1]
        moms = []
        for k in (0, 1):
            conv = rho * (U * (nv * jac[k][:, 0]) + V * (nv * jac[k][:, 1]))
            visc = mu * (nv * (hd[k][:, 0] + hd[k][:, 1]))
            moms.append((conv - visc + npre * jac[2][:, k]) * self.rs)
        return (self.w["PDE_MASS"] * torch.sum(mass * mass)
                + self.w["PDE_MOMU"] * torch.sum(moms[0] * moms[0])
                + self.w["PDE_MOMV"] * torch.sum(moms[1] * moms[1]))

    def _small_losses(self, params):
        mean_sq = lambda r: torch.mean(r * r)
        total = 0.0
        for c in (0, 1):
            for e in DIRICHLET:
                r = mlp.forward(params, self.bnd[e])[:, c] - self.bnd_val[c][e]
                total = total + self.w["BCD"] * mean_sq(r)
        # traction at the outlet (normal +x): mu dU_k/dx - P delta_k0 - rhs
        out, jac, _ = mlp.derivatives(params, self.bnd["DX"], second=())
        for c in (0, 1):
            p_term = self.npre * out[:, 2] if c == 0 else 0.0
            r = ((self.cfg["mu"] * self.nv * jac[c][:, 0] - p_term
                  - self.bnd_val[c]["DX"]) * self.rs)
            total = total + self.w["BCN"] * mean_sq(r)
        out = mlp.forward(params, self.x_vel)
        for c in (0, 1):
            total = total + self.w["FIT"] * mean_sq(out[:, c] - self.fit[c])
        return total

    def value_and_grad(self, params):
        """(loss, [grad of kernel_0, bias_0, ...]) at ``params`` (a list of
        {kernel, bias} of this objective's dtype, leaves that require
        grad); the loss as a 0-d tensor."""
        leaves = mlp.leaves(params)
        n = self.x_pde.shape[0]
        grads = [torch.zeros_like(t) for t in leaves]
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for start in range(0, n, self.block):
            part = (self._pde_sums(params, self.x_pde[start:start + self.block])
                    / self.n_mean)
            for acc, gr in zip(grads, mlp.grad(part, leaves)):
                acc += gr
            total = total + part.detach()
        part = self._small_losses(params)
        for acc, gr in zip(grads, mlp.grad(part, leaves)):
            acc += gr
        return total + part.detach(), grads
