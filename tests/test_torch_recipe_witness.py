"""Why the poisson_misto recipe (Adam 100 + LM 3,000) misses its 5e-8
target on the card: its final test MSE depends on the draw of points and
initial weights, not on the port's training.

- From tpinn's draws (``PRNGKey(1)``, ``MLP(seed=1)``, carried across by
  ``from_arrays``) the port's run ends where tpinn's example ends, within
  1e-6 of it, and both meet the target.
- The port's own draws (torch generator seeds 1-4; the recipe's is 1) end
  on both sides of it.  Seed 1 ends where the card's recipe run ended
  (docs/torch_runs/poisson_misto/summary.json), within 1e-6.

Every run takes the LM damping ladder, the card's default solver (the
port's on one CPU thread), and prints its final test MSE as one JSON line
(shown by ``-rA``).  Five to fifteen minutes a run:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_recipe_witness.py \\
        -m slow -rA -n 5
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_poisson_case import _example, _jax_draws, blas_threads
from tpinn_torch.cases import poisson, poisson_misto

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ITERS = 3000
TARGET = 5e-8
REL_BAR = 1e-6


def _fit(pb):
    return pb.history.losses_test["fit"]["log"][-1]


def _report(**kw):
    print(json.dumps(kw))


@pytest.mark.slow
def test_lm_3000_from_tpinns_draws_ends_where_tpinns_does(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("TPINN_LM_SOLVER", "device")
    params, x_pde, x_test, _, (d0, d1, n0, n1) = _jax_draws()
    jpb, _ = _example("poisson_misto").main(
        LM_ITERS, save_plots=False, out_dir=str(tmp_path), second_round="lm")
    with blas_threads(1):
        tpb, _ = poisson_misto.from_arrays(
            x_pde, np.concatenate([d0, d1]), np.concatenate([n0, n1]),
            x_test, params, device="cpu", second_round="lm")
        poisson.train(tpb, LM_ITERS, "lm")
    ref, got = _fit(jpb), _fit(tpb)
    _report(draws="tpinn", tpinn_fit=ref, port_fit=got)
    assert abs(got / ref - 1.0) < REL_BAR
    assert got <= TARGET and ref <= TARGET


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_port_draws_end_on_both_sides_of_the_target(tmp_path, monkeypatch,
                                                    seed):
    monkeypatch.setenv("TPINN_LM_SOLVER", "device")
    with blas_threads(1):
        pb, _ = poisson_misto.main(LM_ITERS, out_dir=str(tmp_path),
                                   second_round="lm", device="cpu",
                                   seed=seed)
    fit = _fit(pb)
    _report(draws=f"port seed {seed}", port_fit=fit)
    assert (fit <= TARGET) == (seed in (3, 4))
    if seed == 1:
        path = os.path.join(_REPO, "docs", "torch_runs", "poisson_misto",
                            "summary.json")
        with open(path) as f:
            card = json.load(f)["final_test"]["fit"]
        assert abs(fit / card - 1.0) < REL_BAR
