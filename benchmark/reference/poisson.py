"""The Poisson problem, plainly: the inputs a seed makes, and the training
loss with its parameter gradients.

-Laplace(u) = 2 sin x sin y on (0, 2 pi)^2, u = 0 on the boundary, a
2-20-20-20-1 tanh MLP:

    loss = 2 mean((-Laplace(u) - f)^2 over the PDE points)
           + mean(u^2 over the boundary points).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from benchmark.reference import mlp


def forcing(x: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sin(x[:, 0]) * torch.sin(x[:, 1])


def make_inputs(cfg: dict, seed: int, ranks: int = 1) -> dict:
    """The PDE points (``n_pde`` per rank), 20 points on each edge (x = 0,
    x = 2 pi, y = 0, y = 2 pi), the test points, and the initial weights,
    from ``seed``: numpy arrays on the host."""
    s_pts, s_par = mlp.seeds(seed, 2)
    g = torch.Generator().manual_seed(s_pts)
    (lx, ux), (ly, uy) = cfg["extents"]

    def box(n, lo, hi):
        lo = torch.tensor(lo, dtype=torch.float64)
        hi = torch.tensor(hi, dtype=torch.float64)
        return lo + torch.rand(n, 2, generator=g,
                               dtype=torch.float64) * (hi - lo)

    n, nb = cfg["n_pde"] * ranks, cfg["n_bc"]
    x_pde = box(n, [lx, ly], [ux, uy])
    x_bc = torch.cat([box(nb, [lx, ly], [lx, uy]), box(nb, [ux, ly], [ux, uy]),
                      box(nb, [lx, ly], [ux, ly]), box(nb, [lx, uy], [ux, uy])])
    x_test = box(cfg["n_test"], [lx, ly], [ux, uy])
    g = torch.Generator().manual_seed(s_par)
    return {"x_pde": x_pde.numpy(), "x_bc": x_bc.numpy(),
            "x_test": x_test.numpy(),
            "params": mlp.init_params(cfg["layers"], cfg["extents"], g),
            "n_pde_total": n}


class Objective:
    """The training loss of ``inputs`` and its gradients in ``dtype`` on
    ``device``; ``n_rows`` as in the Poiseuille objective."""

    def __init__(self, cfg: dict, inputs: dict, device, dtype=torch.float64,
                 n_rows: Optional[int] = None):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        t = lambda a: torch.as_tensor(np.asarray(a)).to(device=device,
                                                        dtype=dtype)
        n = inputs["n_pde_total"] if n_rows is None else int(n_rows)
        self.x_pde = t(inputs["x_pde"][:n])
        self.x_bc = t(inputs["x_bc"])
        self.block = int(cfg["ref_block"])
        self.w = cfg["weights"]

    def value_and_grad(self, params):
        leaves = mlp.leaves(params)
        n = self.x_pde.shape[0]
        grads = [torch.zeros_like(t) for t in leaves]
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for start in range(0, n, self.block):
            x = self.x_pde[start:start + self.block]
            _, _, hd = mlp.derivatives(params, x, second=(0,))
            r = -(hd[0][:, 0] + hd[0][:, 1]) - forcing(x)
            part = self.w["PDE"] * torch.sum(r * r) / n
            for acc, gr in zip(grads, mlp.grad(part, leaves)):
                acc += gr
            total = total + part.detach()
        u = mlp.forward(params, self.x_bc)
        part = self.w["BC"] * torch.mean(u * u)
        for acc, gr in zip(grads, mlp.grad(part, leaves)):
            acc += gr
        return total + part.detach(), grads
