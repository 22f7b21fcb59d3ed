"""The port's Levenberg–Marquardt round and its driver routing against the
JAX package's, in float64 on the CPU.

Both drivers run the Poiseuille case at full width (2-32-32-32-3) on small
options (30 PDE points, 8 per boundary edge, 4 fit points) from the same
data: tpinn's grid, splits, boundary values, fit targets and θ0 are carried
into tpinn_torch through ``StandardNSDriver.from_arrays``.

* routing: an LM-bound driver keeps the unfused residual losses, each with
  its ``point_residual``; any other driver keeps the fused objective;
* the fast Gram: JᵀJ and Jᵀr at θ0 equal tpinn's ``pb.lm_normal_eqs`` at
  rtol 1e-12 (entries within 1e-13 of the largest count as equal: the two
  sum the rows in another order);
* the round: 4 LM iterations after a 0-epoch Adam round, History logs
  within 1e-8 relative (PERF.md section 2; measured about 2e-12);
* the opt-in forward: with TPINN_USE_PALLAS=1 every training loss at θ0,
  tpinn through its Taylor-bundle kernel in interpret mode, the port
  through kernel 5's route on the CPU, within 1e-12 relative;
* a mis-wired point residual, and the parts of the round that are not
  ported, raise.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tpinn_torch.cases import poiseuille_flow as pf
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import StandardNSDriver, run_second_round
from tpinn_torch.losses import LossMeanSquares, PrecomputedMeanSquares
from tpinn_torch.optimize import minimize
from tpinn_torch.problem import OptimizationProblem

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HISTORY_BAR = 1e-8
SMALL = dict(epochs=4, n_pde=30, n_bc=8, n_vel=4, n_pres=0, n_test=20)


def _jax_example():
    path = os.path.join(_REPO, "examples", "Poiseuille_Flow",
                        "poiseuille_flow.py")
    spec = importlib.util.spec_from_file_location("poiseuille_flow_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_driver(jex, tmp, **kw):
    from tpinn.config import SimulationOptions as JaxOptions
    from tpinn.driver import StandardNSDriver as JaxDriver

    opts = JaxOptions(**{**jex.default_options().__dict__, **SMALL})
    return JaxDriver(jex.build_spec(), opts, base_dir=str(tmp),
                     save_results=False, seed=0, **kw)


def _arrays(jd):
    return dict(
        dom_grid=np.asarray(jd.dom_grid), idx_set=jd.idx_set,
        bnd_pts={k: np.asarray(v) for k, v in jd.bnd_pts.items()},
        bnd_val_num={c: {e: np.asarray(v) for e, v in d.items()}
                     for c, d in jd.bnd_val_num.items()},
        sol_noise=[np.asarray(a) for a in jd.sol_noise],
        params=[{k: np.asarray(p[k]) for k in ("kernel", "bias")}
                for p in jd.model.params])


def _port_driver(arrays, tmp, **kw):
    opts = SimulationOptions(**{**pf.default_options().__dict__, **SMALL})
    kw.setdefault("second_round", "lm")
    return StandardNSDriver.from_arrays(
        pf.build_spec(), opts, base_dir=str(tmp), save_results=False, seed=0,
        adam_epochs=0, device="cpu", **arrays, **kw)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread for the host eigh of both rounds, as
    torch.set_num_threads(1) gives one intra-op thread: tier-1 runs six
    workers, and a 2307 × 2307 eigh on every core in each of them
    oversubscribes the machine."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """tpinn's LM-bound driver on the small options and its data."""
    tmp = tmp_path_factory.mktemp("lm")
    jex = _jax_example()
    jd = _jax_driver(jex, tmp, second_round="lm", adam_epochs=0)
    return jex, jd, _arrays(jd), tmp


def _max_rel_dev(h_ref, h):
    devs = [np.max(np.abs(np.array(h.loss_global) - h_ref.loss_global)
                   / np.abs(h_ref.loss_global))]
    for group in ("losses", "losses_test"):
        ref, got = getattr(h_ref, group), getattr(h, group)
        assert list(got) == list(ref)
        for name in ref:
            a, b = np.array(ref[name]["log"]), np.array(got[name]["log"])
            devs.append(np.max(np.abs(b - a) / np.abs(a)))
    return float(max(devs))


def test_lm_routing_keeps_residual_losses(shared):
    jex, jd, arrays, tmp = shared
    td = _port_driver(arrays, tmp)
    names = [l.name for l in td.losses]
    assert names == [l.name for l in jd.losses]
    assert all(type(l) is LossMeanSquares for l in td.losses)
    for loss in td.losses:
        fn, args = loss.point_residual
        assert callable(fn) and args[0].shape[1] == 2
    # tpinn's LM-bound driver carries the same point residuals
    assert all(getattr(l, "point_residual", None) is not None
               for l in jd.losses)
    # not bound for LM: the fused objective (its plain twin on the CPU)
    td = _port_driver(arrays, tmp, second_round="none")
    assert all(isinstance(l, PrecomputedMeanSquares) for l in td.losses[:3])


def test_fast_gram_matches_tpinn_at_theta0(shared):
    from tpinn.problem import OptimizationProblem as JaxProblem
    import tpinn as jns

    jex, jd, arrays, tmp = shared
    jpb = JaxProblem(jd.model.variables, jd.losses, [], callbacks=[])
    jns.minimize(jpb, "jax", "LM", num_epochs=0)
    assert jpb.lm_used_fast_gram
    td = _port_driver(arrays, tmp)
    tpb = OptimizationProblem(td.model, td.losses, [])
    minimize(tpb, "jax", "LM", num_epochs=0)
    theta0 = tpb.get_vector()
    from jax.flatten_util import ravel_pytree

    np.testing.assert_array_equal(
        theta0, np.asarray(ravel_pytree(jd.model.params)[0]))
    r_j, JTJ_j, JTr_j = jpb.lm_normal_eqs(theta0)
    r_t, JTJ_t, JTr_t = tpb.lm_normal_eqs(theta0)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j[0]), rtol=1e-12,
                               atol=1e-13 * np.abs(np.asarray(r_j[0])).max())
    np.testing.assert_allclose(JTJ_t, np.asarray(JTJ_j), rtol=1e-12,
                               atol=1e-13 * np.abs(JTJ_j).max())
    np.testing.assert_allclose(JTr_t, JTr_j, rtol=1e-12,
                               atol=1e-13 * np.abs(JTr_j).max())


def test_lm_round_matches_tpinn(shared):
    jex, jd, arrays, tmp = shared
    jpb = jd.train(epochs=4, callbacks=False)
    td = _port_driver(arrays, tmp)
    tpb = td.train(epochs=4)
    h, hj = tpb.history, jpb.history
    assert h.round_names == hj.round_names == ["keras_Adam", "jax_LM"]
    assert h.iters == hj.iters
    assert h.loss_global[-1] < 0.1 * h.loss_global[0]
    assert _max_rel_dev(hj, h) < HISTORY_BAR
    assert tpb.last_opt_state["kind"] == "lm"
    np.testing.assert_array_equal(tpb.last_opt_state["theta64"],
                                  tpb.get_vector())
    assert len(tpb.lm_times) == 4
    assert all(set(t) >= {"residuals", "gram", "download", "eigh", "accept"}
               for t in tpb.lm_times)


def test_opt_in_forward_matches_tpinn_kernel(shared, monkeypatch):
    from tpinn.problem import OptimizationProblem as JaxProblem

    jex, _, arrays, tmp = shared
    monkeypatch.setenv("TPINN_USE_PALLAS", "1")
    jd = _jax_driver(jex, tmp, second_round="lm", adam_epochs=0)
    jpb = JaxProblem(jd.model.variables, jd.losses, [], callbacks=[])
    _, j_train, _ = jpb.eval_all(jd.model.params)
    td = _port_driver(arrays, tmp)
    tpb = OptimizationProblem(td.model, td.losses, [])
    _, t_train, _ = tpb.eval_all()
    assert list(t_train) == list(j_train)
    for name, ref in j_train.items():
        ref = float(ref)
        assert abs(t_train[name] - ref) <= 1e-12 * abs(ref), name
    # the PDE and Neumann losses took the kernel route, which is forward
    # only (so an Adam step raises); the Dirichlet and fit losses did not
    for loss in td.losses:
        grad = lambda: torch.autograd.grad(loss.raw_value(), tpb.params,
                                           materialize_grads=True)
        if loss.name.startswith(("PDE", "BCN")):
            with pytest.raises(RuntimeError, match="TPINN_USE_PALLAS"):
                grad()
        else:
            assert all(torch.isfinite(g).all() for g in grad())


def test_miswired_point_residual_raises(shared):
    jex, jd, arrays, tmp = shared
    td = _port_driver(arrays, tmp)
    fit = td.losses[-1]
    fn, (x, rhs) = fit.point_residual
    fit.point_residual = (fn, (x, rhs + 1.0))  # stale fit targets
    pb = OptimizationProblem(td.model, td.losses, [])
    with pytest.raises(NotImplementedError, match="deviates"):
        minimize(pb, "jax", "LM", num_epochs=1)
    fit.point_residual = None
    with pytest.raises(NotImplementedError, match="no point_residual"):
        minimize(pb, "jax", "LM", num_epochs=1)


def test_unported_lm_variants_raise(shared, monkeypatch):
    jex, jd, arrays, tmp = shared
    td = _port_driver(arrays, tmp)
    pb = OptimizationProblem(td.model, td.losses, [])
    monkeypatch.setenv("TPINN_LM_SOLVER", "device")
    with pytest.raises(NotImplementedError, match="damping ladder"):
        minimize(pb, "jax", "LM", num_epochs=1)
    monkeypatch.delenv("TPINN_LM_SOLVER")
    pb.resume_opt_state = {"kind": "lm", "theta64": pb.get_vector(),
                           "mu": 1e-3}
    with pytest.raises(NotImplementedError, match="resuming"):
        minimize(pb, "jax", "LM", num_epochs=1)
    td = _port_driver(arrays, tmp, second_round="none")
    pb = OptimizationProblem(td.model, td.losses, [])
    with pytest.raises(ValueError, match="LossMeanSquares"):
        minimize(pb, "jax", "LM", num_epochs=1)
    opts = SimulationOptions(**{**pf.default_options().__dict__, **SMALL})
    d32 = StandardNSDriver(pf.build_spec(), opts, base_dir=str(tmp),
                           save_results=False, device="cpu",
                           dtype=torch.float32, second_round="lm")
    pb = OptimizationProblem(d32.model, d32.losses, [])
    with pytest.raises(NotImplementedError, match="split"):
        minimize(pb, "jax", "LM", num_epochs=1)


def _routing_problem(arrays, tmp, case):
    """The problem a routing case runs on: the LM-bound driver's losses
    (residual losses with point residuals) in float64, or in float32, or
    with one loss stripped of its point residual, or with a checkpointed
    LM state to resume."""
    if case == "float32":
        opts = SimulationOptions(**{**pf.default_options().__dict__, **SMALL})
        td = StandardNSDriver(pf.build_spec(), opts, base_dir=str(tmp),
                              save_results=False, device="cpu",
                              dtype=torch.float32, second_round="lm")
    else:
        td = _port_driver(arrays, tmp)
    pb = OptimizationProblem(td.model, td.losses, [])
    if case == "no_point_residual":
        pb.losses[-1].point_residual = None
    if case == "lm_resume":
        pb.resume_opt_state = {"kind": "lm", "theta64": pb.get_vector(),
                               "mu": 1e-3}
    return pb


@pytest.mark.parametrize("name,method,case,exc,match", [
    ("scipy", "BFGS", "float32", NotImplementedError, "item 14"),
    ("lm", "BFGS", "float32", NotImplementedError, "item 14"),
    ("jax-bfgss", "BFGS", None, ValueError, "unknown second_round"),
    ("lm", "BFGS", "no_point_residual", NotImplementedError, "item 8"),
    ("gn", "BFGS", "lm_resume", NotImplementedError, "item 8"),
    ("scipy-parityy", "BFGS", None, ValueError, "unknown second_round"),
])
def test_second_round_routing_table(shared, name, method, case, exc, match):
    """What the routing table still refuses: an unknown name (at the
    driver's construction too), and, at the round, the float32 split
    carries (item 14), an LM round on a loss without point residual and
    an LM resume (item 8)."""
    jex, jd, arrays, tmp = shared
    if exc is ValueError:
        with pytest.raises(exc, match=match):
            _port_driver(arrays, tmp, second_round=name, scipy_method=method)
    pb = _routing_problem(arrays, tmp, case)
    with pytest.raises(exc, match=match):
        run_second_round(pb, name, 3, scipy_method=method)
    assert pb.history.round_names == []


_SECOND_ROUND_NAMES = {"lm": "jax_LM", "jax-lm": "jax_LM", "gn": "jax_LM",
                       "scipy": "jax_BFGS", "jax-bfgs": "jax_BFGS",
                       "bfgs": "jax_BFGS", "scipy-parity": "scipy_BFGS",
                       "scipy-host": "scipy_BFGS", "jax": "jax_L-BFGS",
                       "adam": "keras_Adam"}


@pytest.mark.parametrize("name", ["lm", "jax-lm", "gn", "none", None,
                                  "scipy", "jax-bfgs", "bfgs",
                                  "scipy-parity", "scipy-host", "jax",
                                  "adam"])
def test_second_round_names_that_run(shared, name):
    jex, jd, arrays, tmp = shared
    td = _port_driver(arrays, tmp, second_round=name)
    pb = td.train(epochs=0)
    expect = ["keras_Adam"] + ([_SECOND_ROUND_NAMES[name]]
                               if name not in ("none", None) else [])
    assert pb.history.round_names == expect
    assert all(np.isfinite(pb.history.loss_global))


if __name__ == "__main__":
    # The deviation behind the round bar above, from the repo root, on the
    # small options or (with "full") the reference ones:
    #   JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
    #       python tests/test_torch_lm.py [ITERS] [full]
    import sys
    import tempfile

    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    if "full" in sys.argv[2:]:
        SMALL = dict(epochs=iters)
    with tempfile.TemporaryDirectory() as td:
        jex = _jax_example()
        jd = _jax_driver(jex, td, second_round="lm", adam_epochs=0)
        arrays = _arrays(jd)
        jpb = jd.train(epochs=iters, callbacks=False)
        tpb = _port_driver(arrays, td).train(epochs=iters)
    print(f"LM, {iters} iterations: loss_global {jpb.history.loss_global[0]!r}"
          f" -> {jpb.history.loss_global[-1]!r} (tpinn), "
          f"{tpb.history.loss_global[-1]!r} (port); max rel deviation of "
          f"every log {_max_rel_dev(jpb.history, tpb.history):.3e}")
