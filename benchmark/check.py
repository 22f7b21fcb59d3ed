"""The comparison that decides ``correct``: the program's first steps of the
timed round against the plain reference's from the same inputs, and for a
round kind with a late state (``benchmark/rounds/``) also the state its
warm-up round ends in.  The round kinds fill the records; this module names
no method.

The numbers, each held to its limit (``limits/<cell>.json``, which names
the cell's numbers):

* ``loss_gap``: the largest relative gap between the losses of the two
  runs, evaluation by evaluation (a line search's trials included; a
  different count of evaluations reads inf);
* ``grad_gap``: the first gradient as the optimizer got it, by the worst
  leaf: |norm(program) - norm(reference)| over the larger of the
  reference leaf's norm and the median leaf's norm;
* ``change_gap``: the same of the parameters' change over the steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf that no loss moves moves by round-off alone);
* ``dir_gap`` (the late state of an L-BFGS round): the warm-up round's
  last direction, worked out from its last step as (x_now - x_prev) / eta,
  against the reference's two-loop over the program's ring of pairs past
  its wrap, from the same gradient: norm of the difference over the
  reference's norm;
* ``late_grad_gap`` (the same): that gradient, the one the program's state
  holds for x_prev, against the reference's at x_prev, by the worst leaf
  as ``grad_gap``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

def _norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.norm(t.detach().double().reshape(-1)))
            for t in tensors]


def _worst(prog: List[float], ref: List[float], keep=None) -> float:
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    if not idx:
        return math.inf
    med = sorted(ref[i] for i in idx)[len(idx) // 2]
    worst = 0.0
    for i in idx:
        gap = abs(prog[i] - ref[i]) / max(ref[i], med)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def gaps(prog: dict, ref: dict, theta0: Sequence[torch.Tensor]
         ) -> Dict[str, float]:
    """The three numbers of two records {losses, grad0, final} that start
    from the leaves ``theta0`` (kernel_0, bias_0, ...)."""
    lp, lr = prog["losses"], ref["losses"]
    if len(lp) != len(lr):
        loss_gap = math.inf
    else:
        loss_gap = max((abs(a - b) / abs(b) if b != 0 else abs(a - b)
                        for a, b in zip(lp, lr)), default=math.inf)
        if not math.isfinite(loss_gap):
            loss_gap = math.inf
    g_ref = _norms(ref["grad0"])
    grad_gap = _worst(_norms(prog["grad0"]), g_ref)
    med_g = sorted(g_ref)[len(g_ref) // 2]
    keep = [g >= 1e-3 * med_g for g in g_ref]
    cast = lambda ts: [t.detach().to("cpu", torch.float64) for t in ts]
    t0 = cast(theta0)
    dp = _norms([a - b for a, b in zip(cast(prog["final"]), t0)])
    dr = _norms([a - b for a, b in zip(cast(ref["final"]), t0)])
    change_gap = _worst(dp, dr, keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def late_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``dir_gap`` and ``late_grad_gap`` of two records {direction,
    grad_leaves} of the warm-up round's last iteration."""
    d_ref = ref["direction"].double()
    diff = prog["direction"].double() - d_ref
    dir_gap = float(torch.linalg.norm(diff) / torch.linalg.norm(d_ref))
    return {"dir_gap": dir_gap if math.isfinite(dir_gap) else math.inf,
            "late_grad_gap": _worst(_norms(prog["grad_leaves"]),
                                    _norms(ref["grad_leaves"]))}


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}) with every number of ``limits``
    held to its limit; a number that is missing or not finite fails."""
    table = {n: {"value": values.get(n, math.inf), "limit": lim}
             for n, lim in limits.items()}
    ok = all(math.isfinite(row["value"]) and row["value"] <= row["limit"]
             for row in table.values())
    return ok, table
