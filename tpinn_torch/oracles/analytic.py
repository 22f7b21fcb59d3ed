"""Closed-form exact solutions of the analytic cases.

* Poisson: u = sin(x) sin(y), f = 2 sin(x) sin(y) on (0, 2π)²; the
  mixed-BC variant adds the Neumann data ∂u/∂x = cos(x) sin(y).
* Poiseuille: plane channel flow with a pressure drop, with the reference's
  lava parameters.
* Colliding flow: the polynomial Stokes solution on (−1, 1)².
"""

from __future__ import annotations

import dataclasses

import torch


# -- Poisson -----------------------------------------------------------------


def poisson_exact(x):
    return torch.sin(x[:, 0]) * torch.sin(x[:, 1])


def poisson_forcing(x):
    return 2.0 * torch.sin(x[:, 0]) * torch.sin(x[:, 1])


def poisson_neumann_x(x):
    """∂u/∂x = cos(x) sin(y); on the edges x = 0 and x = 2π, sin(y)."""
    return torch.cos(x[:, 0]) * torch.sin(x[:, 1])


# -- Poiseuille (lava channel, reference parameters) -------------------------


@dataclasses.dataclass(frozen=True)
class PoiseuilleParams:
    rho: float = 3100.0  # lava density
    mu: float = 890.0  # lava viscosity
    L: float = 1.0  # channel length
    half_height: float = 0.05  # delta = (Ue_y - Le_y)/2 with Ue_y = 0.1
    p_in: float = 1e6
    p_out: float = 0.0

    @property
    def p_x(self) -> float:
        return self.p_out - self.p_in


def poiseuille_u(x, prm: PoiseuilleParams = PoiseuilleParams()):
    """u(y) = −P_x · y (2 − y/δ) · δ / (2 μ)."""
    return (
        -prm.p_x
        * x[:, 1]
        * (2.0 - x[:, 1] / prm.half_height)
        * prm.half_height
        / (2.0 * prm.mu)
    )


def poiseuille_v(x, prm: PoiseuilleParams = PoiseuilleParams()):
    return 0.0 * x[:, 0]


def poiseuille_p(x, prm: PoiseuilleParams = PoiseuilleParams()):
    return (prm.p_out - prm.p_in) / prm.L * x[:, 0] + prm.p_in


# -- Colliding flow (polynomial Stokes solution) ------------------------------


def colliding_u(x):
    return 20.0 * x[:, 0] * x[:, 1] ** 3


def colliding_v(x):
    return 5.0 * x[:, 0] ** 4 - 5.0 * x[:, 1] ** 4


def colliding_p(x):
    return 60.0 * x[:, 0] ** 2 * x[:, 1] - 20.0 * x[:, 1] ** 3
