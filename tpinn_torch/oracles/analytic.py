"""Closed-form Poiseuille solution: plane channel flow with a pressure drop,
with the reference's lava parameters."""

from __future__ import annotations

import dataclasses


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
