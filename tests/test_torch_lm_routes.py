"""The port's LM routes beyond the host loop on the fast Gram, against the
JAX package's, in float64 on the CPU.

The Poiseuille driver at full width (2-32-32-32-3) on the small options of
tests/test_torch_lm.py, from tpinn's data through ``from_arrays``:

* the device damping ladder (``TPINN_LM_SOLVER=device``, forced in both
  packages): every log within 1e-8 of tpinn's (the LM bar, PERF.md
  section 2), and within 1e-3 of the port's host loop (tpinn's own bar,
  tests/test_lm_fast_gram.py); a rung whose matrix is not positive
  definite is rejected, not raised (``torch.linalg.cholesky`` raises
  where ``jnp.linalg.cholesky`` returns NaN);
* the chunked Jacobian (point residuals stripped, or mis-wired): the
  fallback message, ``lm_used_fast_gram`` False, JᵀJ and Jᵀr at θ0 within
  1e-10 of the fast Gram's and of tpinn's chunked forward-mode Jacobian,
  and a round within 1e-8 of the fast-Gram round, on both solvers;
* resuming an ``lm``-tagged state: 2 + 2 iterations equal 4 straight bit
  for bit on both solvers, through the checkpoint file;
* under ``TPINN_USE_PALLAS=1`` the chunked Jacobian raises in both
  packages (kernel 5 is forward only).
"""


import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tests import test_torch_lm as lm
from tpinn_torch.checkpoint import load_checkpoint, save_checkpoint
from tpinn_torch.optimize import minimize
from tpinn_torch.problem import JAC_CHUNK, OptimizationProblem

torch.set_num_threads(1)

GRAM_BAR = 1e-10
LADDER_VS_HOST = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_routes")
    jex = lm._jax_example()
    jd = lm._jax_driver(jex, tmp, second_round="lm", adam_epochs=0)
    return jex, lm._arrays(jd), tmp


def _port_pb(arrays, tmp, strip=False):
    td = lm._port_driver(arrays, tmp)
    if strip:
        for loss in td.losses:
            loss.point_residual = None
    return OptimizationProblem(td.model, td.losses, td.losses_test)


def _jax_pb(jex, tmp, strip=False):
    import tpinn as jns

    jd = lm._jax_driver(jex, tmp, second_round="lm", adam_epochs=0)
    if strip:
        for loss in jd.losses:
            loss.point_residual = None
    return jns.OptimizationProblem(jd.model.variables, jd.losses,
                                   jd.losses_test, callbacks=[])


def _run(pb, iters, solver, monkeypatch):
    monkeypatch.setenv("TPINN_LM_SOLVER", solver)
    if hasattr(pb, "set_vector"):
        minimize(pb, "jax", "LM", num_epochs=iters)
    else:
        import tpinn as jns

        jns.minimize(pb, "jax", "LM", num_epochs=iters)
    return pb


def test_ladder_matches_tpinn(shared, monkeypatch):
    jex, arrays, tmp = shared
    jpb = _run(_jax_pb(jex, tmp), 4, "device", monkeypatch)
    tpb = _run(_port_pb(arrays, tmp), 4, "device", monkeypatch)
    assert tpb.lm_solver == jpb.lm_solver == "device_ladder"
    assert tpb.history.iters == jpb.history.iters
    assert lm._max_rel_dev(jpb.history, tpb.history) < lm.HISTORY_BAR
    assert tpb.history.loss_global[-1] < 0.1 * tpb.history.loss_global[0]
    assert len(tpb.lm_rungs) == 4 and min(tpb.lm_rungs) >= 1
    assert all(set(t) >= {"residuals", "gram", "power", "cholesky", "solve",
                          "candidate"} for t in tpb.lm_times)
    np.testing.assert_array_equal(tpb.last_theta64, tpb.get_vector())
    # the ladder against the port's host loop, at tpinn's own bar
    host = _run(_port_pb(arrays, tmp), 4, "host", monkeypatch)
    assert host.lm_solver == "host_eigh"
    np.testing.assert_allclose(tpb.history.loss_global,
                               host.history.loss_global, rtol=LADDER_VS_HOST)


def test_auto_takes_the_host_loop_on_the_cpu(shared, monkeypatch):
    jex, arrays, tmp = shared
    pb = _run(_port_pb(arrays, tmp), 1, "auto", monkeypatch)
    assert pb.lm_solver == "host_eigh"


def test_rung_that_is_not_positive_definite_is_rejected(shared, monkeypatch):
    """The first factorization reports a matrix that is not positive
    definite: that rung is rejected (μ ×10) and the next one accepted,
    where ``torch.linalg.cholesky`` would have raised."""
    jex, arrays, tmp = shared
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.tensor([[1.0, 2.0], [2.0, 1.0]]))
    _, info = torch.linalg.cholesky_ex(torch.tensor([[1.0, 2.0],
                                                     [2.0, 1.0]]))
    assert int(info) != 0
    real = torch.linalg.cholesky_ex
    calls = []

    def first_fails(A, **kw):
        L, info = real(A, **kw)
        calls.append(1)
        if len(calls) == 1:
            return torch.full_like(L, float("nan")), torch.ones_like(info)
        return L, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", first_fails)
    pb = _run(_port_pb(arrays, tmp), 1, "device", monkeypatch)
    ref = _run(_port_pb(arrays, tmp), 1, "host", monkeypatch)
    assert pb.lm_rungs == [ref.lm_rungs[0] + 1]
    assert pb.last_opt_state["mu"] == pytest.approx(
        10.0 * ref.last_opt_state["mu"], rel=1e-12)
    assert pb.history.loss_global[-1] < pb.history.loss_global[0]


@pytest.mark.parametrize("case", ["stripped", "miswired"])
def test_chunked_normal_eqs_match_fast_gram_and_tpinn(shared, case, capsys):
    jex, arrays, tmp = shared
    fast = _port_pb(arrays, tmp)
    minimize(fast, "jax", "LM", num_epochs=0)
    assert fast.lm_used_fast_gram
    pb = _port_pb(arrays, tmp, strip=case == "stripped")
    if case == "miswired":
        fn, (x, rhs) = pb.losses[-1].point_residual
        pb.losses[-1].point_residual = (fn, (x, rhs + 1.0))
    minimize(pb, "jax", "LM", num_epochs=0)
    out = capsys.readouterr().out
    assert pb.lm_used_fast_gram is False
    assert ("falling back" in out) == (case == "miswired")
    theta0 = pb.get_vector()
    r_f, JTJ_f, JTr_f = fast.lm_normal_eqs(theta0)
    r_c, JTJ_c, JTr_c = pb.lm_normal_eqs(theta0)
    np.testing.assert_array_equal(r_c.numpy(), r_f.numpy())
    np.testing.assert_allclose(JTJ_c, JTJ_f, rtol=GRAM_BAR,
                               atol=GRAM_BAR * np.abs(JTJ_f).max())
    np.testing.assert_allclose(JTr_c, JTr_f, rtol=GRAM_BAR,
                               atol=GRAM_BAR * np.abs(JTr_f).max())
    # blocks of another size, the last one ragged (2307 = 4·512 + 259):
    # the same rows of Jᵀ as the round's blocks of JAC_CHUNK
    theta_dev = torch.as_tensor(theta0)
    r_256, Jt_256 = pb.residuals_jacobian(theta_dev)
    r_512, Jt_512 = pb.residuals_jacobian(theta_dev, 512)
    assert JAC_CHUNK == 256 and Jt_512.shape == (theta0.size, r_512.numel())
    np.testing.assert_array_equal(r_512.numpy(), r_256.numpy())
    np.testing.assert_allclose(Jt_512.numpy(), Jt_256.numpy(), rtol=1e-12,
                               atol=1e-14 * float(Jt_256.abs().max()))
    jpb = _jax_pb(jex, tmp, strip=True)
    import tpinn as jns

    jns.minimize(jpb, "jax", "LM", num_epochs=0)
    assert jpb.lm_used_fast_gram is False
    _, JTJ_j, JTr_j = jpb.lm_normal_eqs(theta0)
    np.testing.assert_allclose(JTJ_c, np.asarray(JTJ_j), rtol=GRAM_BAR,
                               atol=GRAM_BAR * np.abs(JTJ_c).max())
    np.testing.assert_allclose(JTr_c, JTr_j, rtol=GRAM_BAR,
                               atol=GRAM_BAR * np.abs(JTr_c).max())


@pytest.mark.parametrize("solver", ["host", "device"])
def test_chunked_round_matches_fast_gram_round(shared, solver, monkeypatch):
    jex, arrays, tmp = shared
    fast = _run(_port_pb(arrays, tmp), 2, solver, monkeypatch)
    pb = _run(_port_pb(arrays, tmp, strip=True), 2, solver, monkeypatch)
    assert pb.lm_used_fast_gram is False and fast.lm_used_fast_gram
    assert pb.history.iters == fast.history.iters
    assert lm._max_rel_dev(fast.history, pb.history) < lm.HISTORY_BAR


@pytest.mark.parametrize("solver", ["host", "device"])
def test_resume_two_plus_two_equals_four(shared, solver, monkeypatch,
                                         tmp_path):
    jex, arrays, tmp = shared
    straight = _run(_port_pb(arrays, tmp), 4, solver, monkeypatch)
    first = _run(_port_pb(arrays, tmp), 2, solver, monkeypatch)
    path = tmp_path / "checkpoint.pkl"
    save_checkpoint(path, first.model.params, opt_state=first.last_opt_state)
    ckpt = load_checkpoint(path)
    pb = _port_pb(arrays, tmp)
    pb.model.set_params([{k: torch.as_tensor(np.asarray(p[k]))
                          for k in ("kernel", "bias")}
                         for p in ckpt["params"]])
    pb.resume_opt_state = ckpt["opt_state"]
    seen = []
    pb.callbacks.append(lambda pb_, it, force=False: seen.append(
        dict(pb_.last_opt_state)))
    _run(pb, 2, solver, monkeypatch)
    assert pb.resume_opt_state is None
    # the iteration-0 checkpoint flush already holds the adopted carry
    np.testing.assert_array_equal(seen[0]["theta64"],
                                  first.last_opt_state["theta64"])
    assert seen[0]["mu"] == first.last_opt_state["mu"]
    np.testing.assert_array_equal(pb.last_theta64, straight.last_theta64)
    assert pb.last_opt_state["mu"] == straight.last_opt_state["mu"]
    assert pb.history.loss_global[-1] == straight.history.loss_global[-1]
    np.testing.assert_array_equal(pb.get_vector(), straight.get_vector())


def test_resume_state_that_does_not_fit_cold_starts(shared, monkeypatch):
    """A state of another θ, a malformed one and one of another kind are
    not adopted: the round runs as from the parameters alone; an lm state
    survives a BFGS round for the LM round after it."""
    jex, arrays, tmp = shared
    cold = _run(_port_pb(arrays, tmp), 1, "host", monkeypatch)
    theta = _port_pb(arrays, tmp).get_vector()
    states = [{"kind": "lm", "theta64": theta + 1e-3, "mu": 1e-9},
              {"kind": "lm", "theta64": None, "mu": 1e-3},
              {"kind": "lm", "theta64": theta[:5], "mu": 1e-3},
              {"kind": "lm", "theta64": theta},
              {"kind": "bfgs_paired", "carry": (theta,)}]
    for st in states:
        pb = _port_pb(arrays, tmp)
        pb.resume_opt_state = st
        _run(pb, 1, "host", monkeypatch)
        assert pb.history.loss_global == cold.history.loss_global, st
        assert pb.last_opt_state["mu"] == cold.last_opt_state["mu"]
    pb = _port_pb(arrays, tmp)
    pb.resume_opt_state = {"kind": "lm", "theta64": theta, "mu": 1e-3}
    minimize(pb, "jax", "BFGS", num_epochs=1)
    assert pb.resume_opt_state is not None
    assert pb.resume_opt_state["kind"] == "lm"


def test_mu_is_clamped_on_resume(shared, monkeypatch):
    jex, arrays, tmp = shared
    for mu, want in ((1e20, 1e8), (1e-30, 1e-14)):
        pb = _port_pb(arrays, tmp)
        pb.resume_opt_state = {"kind": "lm", "theta64": pb.get_vector(),
                               "mu": mu}
        seen = []
        pb.callbacks.append(lambda pb_, it, force=False: seen.append(
            pb_.last_opt_state["mu"]))
        _run(pb, 0, "host", monkeypatch)
        assert seen[0] == want


def test_opt_in_chunked_route_raises_in_both_packages(shared, monkeypatch):
    """Kernel 5 has no forward or reverse derivative: the chunked Jacobian
    through a kernel-5 bundle fails in tpinn (interpret mode) and raises,
    naming kernel 5, in the port."""
    jex, arrays, tmp = shared
    monkeypatch.setenv("TPINN_USE_PALLAS", "1")
    jpb = _jax_pb(jex, tmp, strip=True)
    import tpinn as jns

    with pytest.raises(ValueError):  # jax.jvp through the kernel
        jns.minimize(jpb, "jax", "LM", num_epochs=1)
    pb = _port_pb(arrays, tmp, strip=True)
    with pytest.raises(RuntimeError, match="kernel 5.*forward only"):
        minimize(pb, "jax", "LM", num_epochs=1)
    # the fast Gram does not differentiate the kernel: the route runs
    pb = _port_pb(arrays, tmp)
    minimize(pb, "jax", "LM", num_epochs=1)
    assert pb.lm_used_fast_gram
