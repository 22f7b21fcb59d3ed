"""Frozen work counts of the residual kernels, and the device's published
peaks: the yardstick of every roofline share and of ``step_mfu``.

The operation counts are the arithmetic of chip_smoke.py's
``ns_work_split`` / ``poisson_work_split``, copied here so that no change to
the program moves them: per point, the layer products of every Taylor
stream, the dW contractions, one tanh per hidden neuron and the rest of the
stream, residual and cotangent algebra.  At the published widths they are
69,830 / 23,205 operations (NS backward / forward, 2-32-32-32-3) and
27,648 / 9,165 (Poisson, 2-20-20-20-1).

Bytes count each input read once and each output written once: the
points (and the Poisson forcing), the parameters, and for a backward the
parameter cotangents.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

ITEMSIZE = 8  # float64, the configurations' dtype

# NVIDIA's data sheet, H100 SXM, dense rates at the full 700 W
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"fp64_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of a card, None for a card not in the table."""
    return PEAKS.get(kind)


def ns_split(widths: Sequence[int], d_in: int, bwd: bool) -> Dict[str, int]:
    S = 1 + d_in + 2
    L = len(widths) - 1
    w = {"dot": 0, "gram": 0, "tanh": 0, "fma": 0}
    for l in range(L):
        wi, wo = widths[l], widths[l + 1]
        w["dot"] += 2 * wi * wo if l == 0 else 2 * S * wi * wo
        w["fma"] += wo
        if l < L - 1:
            w["tanh"] += wo
            w["fma"] += wo * (2 + 2 + d_in + 2 * (3 if l == 0 else 5))
    w["fma"] += 2 * 14 + 6
    if not bwd:
        return w
    w["fma"] += 30
    for l in range(L - 1, -1, -1):
        wi, wo = widths[l], widths[l + 1]
        if l < L - 1:
            w["fma"] += wo * (6 + 1 + 3 * d_in + 2 * (7 if l > 0 else 5)
                              + d_in + 2 * 3 + 2)
        w["gram"] += 3 * wi * wo if l == 0 else 2 * S * wi * wo
        w["fma"] += wo
        if l > 0:
            w["dot"] += 2 * S * wi * wo
    return w


def poisson_split(widths: Sequence[int], bwd: bool) -> Dict[str, int]:
    d_in, S = 2, 5
    L = len(widths) - 1
    w = {"dot": 0, "gram": 0, "tanh": 0, "fma": 0}
    for l in range(L):
        wi, wo = widths[l], widths[l + 1]
        if l == L - 1:
            w["dot"] += 2 * 2 * wi * wo
            continue
        w["dot"] += 2 * wi * wo if l == 0 else 2 * S * wi * wo
        w["fma"] += wo + wo * (2 + 2 + d_in + 2 * (3 if l == 0 else 5))
        w["tanh"] += wo
    w["fma"] += 5
    if not bwd:
        return w
    w["fma"] += 3
    for l in range(L - 1, -1, -1):
        wi, wo = widths[l], widths[l + 1]
        if l == L - 1:
            w["gram"] += 2 * 2 * wi * wo
            if l > 0:
                w["dot"] += 2 * 2 * wi * wo
            continue
        w["fma"] += wo * (6 + 1 + 3 * d_in + 2 * (7 if l > 0 else 5)
                          + d_in + 2 * 3 + 2) + wo
        w["gram"] += 3 * wi * wo if l == 0 else 2 * S * wi * wo
        if l > 0:
            w["dot"] += 2 * S * wi * wo
    return w


def flops_per_point(problem: str, widths: Sequence[int], bwd: bool) -> int:
    if problem == "poisson":
        return sum(poisson_split(widths, bwd).values())
    return sum(ns_split(widths, widths[0], bwd).values())


def n_params(widths: Sequence[int]) -> int:
    return sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))


def launch_bytes(problem: str, widths: Sequence[int], points: int,
                 bwd: bool) -> int:
    """Bytes one launch over ``points`` points must move at the least."""
    per_point = widths[0] + (1 if problem == "poisson" else 0)
    params = n_params(widths) * (2 if bwd else 1)
    return ITEMSIZE * (points * per_point + params + 4)


def least_seconds(problem: str, widths: Sequence[int], points: int,
                  bwd: bool, kind: str):
    """(seconds, "operations" | "bytes"): the least time one launch over
    ``points`` points could take on the card, and which peak bounds it;
    None for a card without published peaks."""
    pk = peaks(kind)
    if pk is None:
        return None
    t_ops = points * flops_per_point(problem, widths, bwd) / pk["fp64_flops"]
    t_bytes = launch_bytes(problem, widths, points, bwd) / pk["hbm_bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
