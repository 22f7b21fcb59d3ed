"""The port's Poisson cases against the JAX package's examples.

Each parity test runs the example (examples/Poisson_Problem/*.py, float64
on the CPU: 100 Adam epochs, then 20 L-BFGS-B iterations) and the port's
case from the same θ0 (tpinn's ``MLP(..., seed=1)``) and the same points
(tpinn's ``PRNGKey(1)`` draws), carried across through ``from_arrays``.
On the CPU tpinn takes its tape path and the port the fused objective's
plain twin.  The two History logs are compared by their largest relative
deviation: the Adam part at 1e-10, the L-BFGS-B part at 1e-8 (PERF.md §2:
the measured deviations are ≤ 5e-13 over the Adam part and ≤ 1.4e-10 after
20 L-BFGS-B iterations, which amplify rounding about tenfold per ten
iterations).
"""

import contextlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.geometry import sample_box as jax_sample_box
from tpinn.history import History as JaxHistory
from tpinn.models import MLP as JaxMLP
from tpinn_torch import utils
from tpinn_torch.bridge import params_from_numpy, params_to_numpy
from tpinn_torch.cases import poisson, poisson_misto
from tpinn_torch.history import History
from tpinn_torch.losses import LossMeanSquares, PrecomputedMeanSquares
from tpinn_torch.models import MLP
from tpinn_torch.optimize import minimize
from tpinn_torch.problem import OptimizationProblem

torch.set_num_threads(1)

try:
    # numpy's BLAS on one thread in the LM rounds, as torch here: the suite
    # runs several workers, each of whose eigh would spin on every core
    from threadpoolctl import threadpool_limits as blas_threads
except ImportError:  # without threadpoolctl the threads stay as they are
    def blas_threads(limit):
        return contextlib.nullcontext()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 2 * np.pi
ADAM_BAR = 1e-10
SCIPY_BAR = 1e-8
SCIPY_ITERS = 20
LM_ITERS = 5
LM_BAR = 1e-8


def _example(name):
    path = os.path.join(_REPO, "examples", "Poisson_Problem", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{name}_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_draws():
    """θ0 and the point sets exactly as the examples draw them."""
    ks = jax.random.split(jax.random.PRNGKey(1), 8)
    jm = JaxMLP(2, 1, width=20, depth=3, seed=1,
                input_extents=[(0.0, W), (0.0, W)])
    params = [{k: np.asarray(p[k]) for k in ("kernel", "bias")}
              for p in jm.params]
    box = lambda k, n, lo, hi: np.asarray(jax_sample_box(ks[k], n, lo, hi))
    edges = [box(1, 20, [0, 0], [0, W]), box(2, 20, [W, 0], [W, W]),
             box(3, 20, [0, 0], [W, 0]), box(4, 20, [0, W], [W, W])]
    x_pde = box(0, 200, [0, 0], [W, W])
    x_test = box(5, 1000, [0, 0], [W, W])
    misto_edges = [box(1, 20, [0, 0], [W, 0]), box(2, 20, [0, W], [W, W]),
                   box(3, 20, [0, 0], [0, W]), box(4, 20, [W, 0], [W, W])]
    return params, x_pde, x_test, edges, misto_edges


def _rel_devs_at(h_ref, h, sel):
    """Largest relative deviation of each logged series at the log-point
    indices ``sel``."""
    series = [(h_ref.loss_global, h.loss_global)]
    for group in ("losses", "losses_test"):
        ref, got = getattr(h_ref, group), getattr(h, group)
        assert list(got) == list(ref)
        series += [(ref[k]["log"], got[k]["log"]) for k in ref]
    return [float(np.max(np.abs(np.array(b)[sel] - np.array(a)[sel])
                         / np.abs(np.array(a)[sel]))) for a, b in series]


def _rel_devs(h_ref, h, rounds):
    """Largest relative deviation of every logged value at the log points
    of the given (1-based) rounds."""
    sel = [i for i, r in enumerate(h_ref.rounds_idx) if r in rounds]
    return max(_rel_devs_at(h_ref, h, sel))


def _run_pair(name, scipy_iters, out_dir, second_round="scipy"):
    """(tpinn's problem, the port's problem) after the example's rounds:
    100 Adam epochs, then ``scipy_iters`` iterations of ``second_round``
    (L-BFGS-B by default), from the same θ0 and points."""
    params, x_pde, x_test, edges, (d0, d1, n0, n1) = _jax_draws()
    jpb, _ = _example(name).main(scipy_iters, save_plots=False,
                                 out_dir=out_dir, second_round=second_round)
    if name == "poisson":
        tpb, _ = poisson.from_arrays(x_pde, np.concatenate(edges), x_test,
                                     params, device="cpu",
                                     second_round=second_round)
    else:
        tpb, _ = poisson_misto.from_arrays(
            x_pde, np.concatenate([d0, d1]), np.concatenate([n0, n1]),
            x_test, params, device="cpu", second_round=second_round)
    poisson.train(tpb, scipy_iters, second_round)
    return jpb, tpb


def _check_parity(jpb, tpb):
    hj, ht = jpb.history, tpb.history
    assert ht.round_names == hj.round_names == ["keras_Adam", "scipy_L-BFGS-B"]
    assert ht.iters == hj.iters and ht.round_starts == hj.round_starts
    assert ht.iter_round[-1] == hj.iter_round[-1] <= SCIPY_ITERS
    assert _rel_devs(hj, ht, {1}) < ADAM_BAR
    assert _rel_devs(hj, ht, {2}) < SCIPY_BAR
    for name, entry in hj.losses.items():
        assert ht.losses[name]["weight"] == entry["weight"]
    # value and gradient at tpinn's final θ (the scipy round's function)
    theta = jpb.variables.get()
    vec, _ = jax.flatten_util.ravel_pytree(theta)
    v_ref, g_ref = jpb.value_and_grad()(theta)
    g_ref, _ = jax.flatten_util.ravel_pytree(g_ref)
    v, g = tpb.value_and_grad_vector(np.asarray(vec))
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-12)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=1e-9, atol=1e-12)


def test_poisson_history_matches_tpinn(tmp_path):
    jpb, tpb = _run_pair("poisson", SCIPY_ITERS, str(tmp_path / "jax"))
    # the 2-20-20-20-1 net goes through the fused objective (plain twin)
    assert isinstance(tpb.losses[0], PrecomputedMeanSquares)
    _check_parity(jpb, tpb)


def test_poisson_misto_history_matches_tpinn(tmp_path):
    jpb, tpb = _run_pair("poisson_misto", SCIPY_ITERS, str(tmp_path / "jax"))
    assert [l.name for l in tpb.losses] == ["PDE", "BC_D", "BC_N"]
    _check_parity(jpb, tpb)


@pytest.mark.parametrize("name", ["poisson", "poisson_misto"])
def test_lm_route_matches_tpinn(tmp_path, name):
    """Adam 100 + LM 5 from tpinn's θ0 and points: the PDE loss is the tape
    closure (not the fused objective) and every training loss has its
    point residual, as the example routes an LM-bound run; every log point
    within 1e-8 of the example's."""
    with blas_threads(1):
        jpb, tpb = _run_pair(name, LM_ITERS, str(tmp_path / "jax"), "lm")
    assert type(tpb.losses[0]) is LossMeanSquares
    assert all(l.point_residual is not None for l in tpb.losses)
    hj, ht = jpb.history, tpb.history
    assert ht.round_names == hj.round_names == ["keras_Adam", "jax_LM"]
    assert ht.iters == hj.iters and ht.round_starts == hj.round_starts
    assert ht.iter_round[-1] == hj.iter_round[-1] == LM_ITERS
    assert max(_rel_devs_at(hj, ht, list(range(len(hj.iters))))) < LM_BAR
    lm_start = ht.rounds_idx.index(2)
    assert ht.loss_global[-1] < 0.5 * ht.loss_global[lm_start]


@pytest.mark.parametrize("case,name", [(poisson, "Poisson"),
                                       (poisson_misto, "Poisson_misto")])
def test_main_writes_history(tmp_path, case, name):
    pb, model = case.main(epochs=7, out_dir=str(tmp_path), device="cpu")
    path = tmp_path / "Images" / f"{name}_history_loss.json"
    assert sorted(os.listdir(tmp_path)) == ["Images"]
    assert os.listdir(tmp_path / "Images") == [path.name]
    h = History.load(path)
    assert h.round_names == ["keras_Adam", "scipy_L-BFGS-B"]
    assert h.iters[:11] == list(range(0, 101, 10))
    assert h.round_starts == [0, 101]
    assert h.iter_round[11] == 0 and h.iter_round[-1] <= 7
    assert all(np.isfinite(h.loss_global))
    assert h.loss_global[-1] < h.loss_global[0]
    # the JAX package reads the file
    assert JaxHistory.load(str(path)).loss_global == h.loss_global
    total = sum(e["weight"] * e["log"][-1] for e in h.losses.values())
    np.testing.assert_allclose(h.loss_global[-1], total, rtol=1e-14)
    # a seed gives the same run
    pb2, _ = case.main(epochs=7, out_dir=str(tmp_path / "again"),
                       device="cpu")
    assert pb2.history.loss_global == h.loss_global


def test_main_refuses_unported_second_round(tmp_path):
    """The LM route runs through ``main`` (it raised before it was ported);
    ``main`` without an output directory still refuses."""
    with pytest.raises(ValueError, match="out_dir"):
        poisson_misto.main(5, device="cpu")
    assert not os.listdir(tmp_path)
    pb, _ = poisson.main(2, out_dir=str(tmp_path), second_round="lm",
                         device="cpu")
    h = pb.history
    assert h.round_names == ["keras_Adam", "jax_LM"]
    assert h.iter_round[-1] == 2 and np.isfinite(h.loss_global).all()
    assert os.listdir(tmp_path / "Images") == ["Poisson_history_loss.json"]


def test_scipy_round_logs_like_tpinn():
    """The scipy round's log points: 0, every tenth iteration, and the last
    one when it is not a multiple of ten; the model keeps the result."""
    torch.manual_seed(0)
    model = MLP(2, 1, width=8, depth=1, device="cpu")
    x = torch.rand(30, 2, dtype=torch.float64)
    y = torch.sin(3.0 * x[:, :1])
    pb = OptimizationProblem(model.variables,
                             [LossMeanSquares("fit", lambda: model(x) - y)])
    minimize(pb, "scipy", "L-BFGS-B", num_epochs=25)
    h = pb.history
    assert h.round_names == ["scipy_L-BFGS-B"]
    assert h.iter_round == [0, 10, 20, 25]
    with torch.no_grad():
        final = float(torch.mean((model(x) - y) ** 2))
    assert h.losses["fit"]["log"][-1] == final < h.losses["fit"]["log"][0]
    # LM on a loss without point residual: the chunked Jacobian
    minimize(pb, "jax", "LM", num_epochs=3)
    assert pb.lm_used_fast_gram is False
    assert h.round_names == ["scipy_L-BFGS-B", "jax_LM"]
    assert h.loss_global[-1] <= final


def test_vector_order_is_tpinn_ravel_order():
    jm = JaxMLP(2, 1, width=20, depth=3, seed=1, dtype=jnp.float64,
                input_extents=[(0.0, W), (0.0, W)])
    model = MLP(2, 1, width=20, depth=3, device="cpu")
    pb = OptimizationProblem(model, [])
    model.set_params(params_from_numpy(jm.params))
    vec, _ = jax.flatten_util.ravel_pytree(jm.params)
    np.testing.assert_array_equal(pb.get_vector(), np.asarray(vec))
    pb.set_vector(np.asarray(vec) * 2.0)
    np.testing.assert_array_equal(pb.get_vector(), 2.0 * np.asarray(vec))
    with pytest.raises(ValueError, match="values for"):
        pb.set_vector(np.zeros(vec.size + 1))


def test_scalar_head_weights_round_trip():
    """A 1-output MLP crosses the bridge both ways and computes tpinn's
    outputs from the same θ."""
    jm = JaxMLP(2, 1, width=20, depth=3, seed=1, dtype=jnp.float64,
                input_extents=[(0.0, W), (0.0, W)])
    model = MLP(2, 1, width=20, depth=3, device="cpu")
    model.variables.set(params_from_numpy(jm.params))
    back = params_to_numpy(model.variables.get())
    for p, q in zip(back, jm.params):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(p[k], np.asarray(q[k]))
    x = np.random.default_rng(0).uniform(0, W, (50, 2))
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
    assert got.shape == (50, 1)
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-15)


def test_json_and_plot_history(tmp_path):
    path = tmp_path / "sub" / "h.json"
    utils.save_json({"a": [1, 2.5]}, path)
    assert utils.load_json(path) == {"a": [1, 2.5]}
    pb, _ = poisson.main(epochs=0, out_dir=str(tmp_path), device="cpu")
    hist = tmp_path / "Images" / "Poisson_history_loss.json"
    with open(hist) as f:
        rounds = json.load(f)["log_rounds"]["rounds"]
    assert rounds == ["keras_Adam", "scipy_L-BFGS-B"]
    pytest.importorskip("matplotlib")
    utils.plot_history(str(hist))
    assert (tmp_path / "Images" / "Poisson_history_loss.png").exists()


if __name__ == "__main__":
    # The deviations behind the bars above, per L-BFGS-B log point, from
    # the repo root:
    #   JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
    #       python tests/test_torch_poisson_case.py [ITERS]
    import sys
    import tempfile

    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    for case in ("poisson", "poisson_misto"):
        with tempfile.TemporaryDirectory() as td:
            jpb, tpb = _run_pair(case, iters, td)
        h = jpb.history
        print(f"{case}: Adam (100 epochs) max rel deviation "
              f"{_rel_devs(h, tpb.history, {1}):.3e}")
        for i, (r, it) in enumerate(zip(h.rounds_idx, h.iter_round)):
            if r == 2:
                sel = [j for j in range(i + 1) if h.rounds_idx[j] == 2]
                dev = max(_rel_devs_at(h, tpb.history, sel))
                print(f"  L-BFGS-B up to iteration {it}: {dev:.3e}")
