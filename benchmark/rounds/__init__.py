"""Round kinds, found by name.  A traffic step's ``method``, lower-cased,
names the file that runs and follows it: ``"Adam"`` is ``rounds/adam.py``,
``"L-BFGS"`` is ``rounds/l-bfgs.py``.  ``spec.round_kind`` loads the file by
path; a method with no file fails at set-up, naming the file it looked for.
The check steps, each set-up round, the warm-up and the timed round each use
their own step's method.  A new kind of round is one new file here: the
harness, the control and the comparison (``benchmark.check``) name no
method.

A round kind provides

* ``run(pb, step, n, lr)``: one round of the program's ``minimize`` for ``n``
  steps of the traffic step ``step`` (its ``strategy`` and ``method``) on the
  problem ``pb``; ``lr`` is the configuration's ``adam_lr``.  The set-up
  rounds, the warm-up and the window run through it.
* ``check_steps(pb, model, step, lr) -> record``: the timed round's own call
  for its first ``step["steps"]`` steps from the seed's weights, recorded.
* ``reference(objective, params, step, cfg) -> record``: the plain
  reference of the same steps (``benchmark/reference/optim.py``) on
  ``objective`` (``reference/<problem>.py``'s ``Objective``) from the leaves
  ``params``.

The record is what ``check.gaps`` compares, with these keys and no other:

* ``losses``: the loss of every evaluation the round makes, in order, as
  floats (a line search's trials included);
* ``grad0``: the first gradient as the optimizer got it, as leaves (kernel_0,
  bias_0, kernel_1, ...);
* ``final``: the parameters after the steps, as the same leaves.

A Levenberg-Marquardt kind fills it so: ``losses``, every rung's ||r||^2 in
order; ``grad0``, 2 J^T r at the start, as leaves; ``final``, the parameters
after its k iterations.

Optional, for a round whose late state the check holds as well (today
``rounds/l-bfgs.py``; its cells' limits then name ``dir_gap`` and
``late_grad_gap``):

* ``late_state(pb, count) -> late``: what the warm-up round of ``count``
  steps leaves, on the host;
* ``late_program(late)`` and ``late_reference(cfg, ref_mod, inputs, late,
  device, dtype=torch.float64, **fault)``: the two records {direction,
  grad_leaves} of its last iteration that ``check.late_gaps`` compares
  (``fault``: a planted fault of the reference's objective);
* ``traced_split(pb, step, n, lr) -> list``: in a traced run, the window's
  round once more from the same parameters, returning the program's
  per-iteration split, which the run keeps as ``lbfgs_times``.
"""

from __future__ import annotations

import torch


def record(losses, grad0, model) -> dict:
    """A check record from the losses as recorded (0-d tensors), the first
    gradient's leaves and the model after the steps, on the host."""
    return {"losses": torch.stack(losses).tolist(),
            "grad0": [g.detach().cpu() for g in grad0],
            "final": [t.detach().cpu().clone() for t in model.flat_params()]}
