"""The float32 split-parameter carries of LM and dense BFGS against the JAX
package's, on the CPU.

* the error-free sums ``_two_sum`` / ``_df_add`` equal tpinn's (its own
  code objects, run under ``jax.jit``) bit for bit on 10⁴ random float32
  pairs and triples spread over 60 binades;
* the LM split normal equations at a θ64 with a sub-ulp lo, as
  tests/test_lm_fast_gram.py holds tpinn's: JᵀJ = J(hi)ᵀJ(hi) and
  Jᵀr = J(hi)ᵀr(hi) + JᵀJ·lo at rtol 2e-4, and the lo correction exact
  between two points of the same hi; the chunked route's split equations
  against the fast Gram's;
* dense BFGS split (``bfgs_split``), 5 iterations of the Poiseuille driver
  at full width on the small options of tests/test_torch_lm.py, from
  tpinn's data in float32: every log within ``SPLIT_BAR`` of tpinn's
  (measured 1.0e-6 over 5 iterations and 5.5e-6 over 20, the first log
  already 3.7e-7 apart: float32 roundings of two libraries), the lo
  channel nonzero;
* both carries navigate below the float32 parameter grid on tpinn's
  lattice problem (tests/test_optimize_bfgs.py) and resume across a
  checkpoint (tests/test_optimize_resume.py), a stale carry discarded;
* under ``TPINN_USE_PALLAS=1`` both carries raise in both packages
  (kernel 5 has no derivative).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tpinn as jns
from tests import test_torch_lm as lm
from tests.test_torch_bfgs import TinyModel
from tpinn_torch.checkpoint import load_checkpoint, save_checkpoint
from tpinn_torch.config import SimulationOptions
from tpinn_torch.cases import poiseuille_flow as pf
from tpinn_torch.driver import StandardNSDriver
from tpinn_torch.losses import LossMeanSquares
from tpinn_torch.optimize import _df_add, _two_sum, minimize
from tpinn_torch.problem import OptimizationProblem

torch.set_num_threads(1)

# every log of the 5-iteration float32 BFGS round, port against tpinn
SPLIT_BAR = 1e-5
# every log of the 5-iteration float32 LM round, port against tpinn
# (measured 3.3e-5: one log point after the iteration-0 one)
SPLIT_LM_BAR = 1e-4
# the LM split normal equations, port against tpinn, of the largest entry
# (measured 1.7e-6 on r(hi), 2.6e-7 on dr, 4.1e-7 on JᵀJ, 3.6e-7 on Jᵀr and
# 8.0e-7 on the JᵀJ·lo correction, itself 4.5e-8 of Jᵀr)
SPLIT_EQS_BAR = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@contextlib.contextmanager
def _jax_f32():
    from tpinn import config

    config.set_dtype(jnp.float32)
    try:
        yield
    finally:
        config.set_dtype(None)


def _tpinn_sums():
    """tpinn's ``_two_sum`` and ``_df_add``, nested in its dense BFGS round,
    rebuilt from their code objects (no copy of their text)."""
    import tpinn.optimize as jo

    codes = {c.co_name: c for c in jo._minimize_jax_bfgs.__code__.co_consts
             if isinstance(c, types.CodeType)}
    two_sum = types.FunctionType(codes["_two_sum"], vars(jo))
    df_add = types.FunctionType(codes["_df_add"], vars(jo), None, None,
                                (types.CellType(two_sum),))
    return jax.jit(two_sum), jax.jit(df_add)


def _random_f32(rng, n):
    return (rng.choice([-1.0, 1.0], n) * 2.0 ** rng.uniform(-30, 30, n)
            ).astype(np.float32)


def test_two_sum_and_df_add_bit_identical_to_tpinn():
    j_two_sum, j_df_add = _tpinn_sums()
    rng = np.random.default_rng(0)
    a, b, c = (_random_f32(rng, 10_000) for _ in range(3))
    # pairs of near magnitudes too, where the error term is exact and small
    b[:2000] = (a[:2000] * (1 + 1e-3 * rng.standard_normal(2000))
                ).astype(np.float32)
    for got, ref in ((_two_sum(*map(torch.as_tensor, (a, b))),
                      j_two_sum(a, b)),
                     (_df_add(*map(torch.as_tensor, (a, b, c))),
                      j_df_add(a, b, c))):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          np.asarray(r).view(np.int32))
    s, err = _two_sum(torch.as_tensor(a), torch.as_tensor(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(s.double().numpy() + err.double().numpy(),
                                  exact)


# ---------------------------------------------------------------------------
# LM split normal equations (the driver in float32, the port's own draws)
# ---------------------------------------------------------------------------

def _driver32(second_round="lm", **kw):
    opts = SimulationOptions(**{**pf.default_options().__dict__, **lm.SMALL})
    return StandardNSDriver(pf.build_spec(), opts, base_dir=".",
                            save_results=False, device="cpu",
                            dtype=torch.float32, second_round=second_round,
                            seed=0, **kw)


def test_lm_split_normal_equations_at_a_sub_ulp_lo():
    d = _driver32()
    pb = OptimizationProblem(d.model, d.losses, [])
    minimize(pb, "jax", "LM", num_epochs=2)
    assert pb.lm_used_fast_gram is True and pb.lm_solver == "host_eigh"
    assert pb.history.loss_global[-1] <= pb.history.loss_global[0]
    assert pb.last_theta64.dtype == np.float64

    theta0 = pb.get_vector()
    rng = np.random.default_rng(3)
    theta64 = theta0 + 1e-9 * rng.standard_normal(theta0.shape[0])
    (r, dr), JTJ, JTr = pb.lm_normal_eqs(theta64)
    assert JTJ.dtype == np.float32 and JTr.dtype == np.float64
    hi32 = theta64.astype(np.float32)
    lo64 = theta64 - hi32.astype(np.float64)
    r_ref, Jt = pb.residuals_jacobian(torch.as_tensor(hi32))
    J = Jt.double().numpy().T
    JTJ_ref = J.T @ J
    JTr_ref = J.T @ r_ref.double().numpy() + JTJ_ref @ lo64
    np.testing.assert_allclose(JTJ, JTJ_ref, rtol=2e-4,
                               atol=1e-6 * np.abs(JTJ_ref).max())
    np.testing.assert_allclose(JTr, JTr_ref, rtol=2e-4,
                               atol=1e-6 * np.abs(JTr_ref).max())
    np.testing.assert_allclose(dr.double().numpy(), J @ lo64, rtol=1e-3,
                               atol=1e-4 * np.abs(J @ lo64).max())
    # two points of one hi: the same G and r(hi), so the difference of
    # their Jᵀr is the host-float64 JᵀJ·lo term alone
    theta_a = hi32.astype(np.float64)
    theta_b = theta_a + 1e-8 * theta_a
    assert np.array_equal(theta_b.astype(np.float32), hi32)
    _, JTJ_a, JTr_a = pb.lm_normal_eqs(theta_a)
    _, JTJ_b, JTr_b = pb.lm_normal_eqs(theta_b)
    np.testing.assert_array_equal(JTJ_a, JTJ_b)
    corr = JTJ_a.astype(np.float64) @ (theta_b - theta_a)
    np.testing.assert_allclose(
        JTr_b - JTr_a, corr, rtol=1e-9,
        atol=4 * np.finfo(np.float64).eps * np.abs(JTr_a).max())
    assert np.abs(corr).max() > 0
    # the chunked route keeps Jᵀr and Jᵀdr apart: the same equations
    for loss in pb.losses:
        loss.point_residual = None
    minimize(pb, "jax", "LM", num_epochs=0)
    assert pb.lm_used_fast_gram is False
    pb.set_vector(theta0)
    _, JTJ_c, JTr_c = pb.lm_normal_eqs(theta64)
    np.testing.assert_allclose(JTJ_c, JTJ_ref, rtol=2e-4,
                               atol=1e-6 * np.abs(JTJ_ref).max())
    np.testing.assert_allclose(JTr_c, JTr_ref, rtol=2e-4,
                               atol=1e-6 * np.abs(JTr_ref).max())


def test_device_solver_never_takes_the_split_carry(monkeypatch):
    monkeypatch.setenv("TPINN_LM_SOLVER", "device")
    d = _driver32()
    pb = OptimizationProblem(d.model, d.losses, [])
    minimize(pb, "jax", "LM", num_epochs=1)
    assert pb.lm_solver == "host_eigh"


# ---------------------------------------------------------------------------
# LM split against tpinn (the Poiseuille driver in float32, tpinn's data)
# ---------------------------------------------------------------------------

def _lm32_pair(tmp_path, epochs=None):
    """tpinn's float32 LM-bound driver and the port's on its arrays
    (``from_arrays``); ``epochs`` trains both that many LM iterations, else
    each gets a problem set up by ``minimize(..., num_epochs=0)``."""
    jex = lm._jax_example()
    with _jax_f32():
        jd = lm._jax_driver(jex, tmp_path, second_round="lm", adam_epochs=0)
        arrays = lm._arrays(jd)
        if epochs is not None:
            jpb = jd.train(epochs=epochs, callbacks=False)
        else:
            jpb = jns.OptimizationProblem(jd.model.variables, jd.losses, [],
                                          callbacks=[])
            jns.minimize(jpb, "jax", "LM", num_epochs=0)
    td = StandardNSDriver.from_arrays(
        pf.build_spec(), SimulationOptions(**{**pf.default_options().__dict__,
                                              **lm.SMALL}),
        base_dir=str(tmp_path), save_results=False, seed=0, adam_epochs=0,
        device="cpu", dtype=torch.float32, second_round="lm", **arrays)
    if epochs is not None:
        return jpb, td.train(epochs=epochs, callbacks=False)
    tpb = OptimizationProblem(td.model, td.losses, [])
    minimize(tpb, "jax", "LM", num_epochs=0)
    return jpb, tpb


def test_lm_split_round_matches_tpinn(tmp_path, monkeypatch):
    monkeypatch.setenv("TPINN_USE_PALLAS", "0")
    jpb, tpb = _lm32_pair(tmp_path, epochs=5)
    assert jpb.lm_used_fast_gram and tpb.lm_used_fast_gram
    assert tpb.lm_solver == "host_eigh"
    assert tpb.history.round_names == jpb.history.round_names == [
        "keras_Adam", "jax_LM"]
    assert tpb.history.iters == jpb.history.iters
    assert lm._max_rel_dev(jpb.history, tpb.history) < SPLIT_LM_BAR
    assert tpb.history.loss_global[-1] < 0.1 * tpb.history.loss_global[0]
    # the carry: float64 θ whose float32 rounding is the parameters, with
    # a lo part below the float32 grid, as tpinn's
    assert str(jpb.last_opt_state["kind"]) == tpb.last_opt_state["kind"] \
        == "lm"
    theta64 = tpb.last_opt_state["theta64"]
    np.testing.assert_array_equal(theta64.astype(np.float32),
                                  tpb.get_vector())
    assert np.count_nonzero(theta64 - tpb.get_vector().astype(np.float64))
    np.testing.assert_array_equal(tpb.last_theta64, theta64)


def test_lm_split_normal_equations_match_tpinn(tmp_path, monkeypatch):
    """Both packages' ``lm_normal_eqs`` at a θ64 with a sub-ulp lo: r(hi),
    dr = J(hi)·lo, JᵀJ and Jᵀr within ``SPLIT_EQS_BAR`` of the largest
    entry of tpinn's; and the host-float64 JᵀJ·lo correction, the
    difference of Jᵀr between two points of one hi (below that bar in Jᵀr
    itself), within the same bar of tpinn's."""
    monkeypatch.setenv("TPINN_USE_PALLAS", "0")
    jpb, tpb = _lm32_pair(tmp_path)
    assert jpb.lm_used_fast_gram and tpb.lm_used_fast_gram
    theta0 = tpb.get_vector()
    rng = np.random.default_rng(3)
    theta64 = theta0 + 1e-9 * rng.standard_normal(theta0.shape[0])
    hi32 = theta64.astype(np.float32)
    theta_a = hi32.astype(np.float64)
    theta_b = theta_a + 1e-8 * theta_a
    assert np.array_equal(theta_b.astype(np.float32), hi32)
    eqs = {}
    for name, pb in (("tpinn", jpb), ("port", tpb)):
        with _jax_f32():
            eqs[name] = [pb.lm_normal_eqs(t) for t in (theta64, theta_a,
                                                       theta_b)]

    def close(got, ref):
        got, ref = (np.asarray(a, np.float64) for a in (got, ref))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=SPLIT_EQS_BAR * np.abs(ref).max())

    (rj, drj), JTJ_j, JTr_j = eqs["tpinn"][0]
    (rt, drt), JTJ_t, JTr_t = eqs["port"][0]
    assert JTJ_t.dtype == np.asarray(JTJ_j).dtype == np.float32
    assert JTr_t.dtype == JTr_j.dtype == np.float64
    close(rt.numpy(), rj)
    close(drt.numpy(), drj)
    assert np.abs(np.asarray(drj)).max() > 0
    close(JTJ_t, JTJ_j)
    close(JTr_t, JTr_j)
    corr = {name: e[2][2] - e[1][2] for name, e in eqs.items()}
    assert np.abs(corr["tpinn"]).max() < SPLIT_EQS_BAR * np.abs(JTr_j).max()
    close(corr["port"], corr["tpinn"])


# ---------------------------------------------------------------------------
# dense BFGS split against tpinn
# ---------------------------------------------------------------------------

def test_bfgs_split_round_matches_tpinn(tmp_path, monkeypatch):
    jex = lm._jax_example()
    with _jax_f32():
        jd = lm._jax_driver(jex, tmp_path, second_round="jax-bfgs",
                            adam_epochs=0)
        arrays = lm._arrays(jd)
        jpb = jd.train(epochs=5, callbacks=False)
    assert str(jpb.last_opt_state["kind"]) == "bfgs_split"
    monkeypatch.setenv("TPINN_USE_PALLAS", "0")
    td = StandardNSDriver.from_arrays(
        pf.build_spec(), SimulationOptions(**{**pf.default_options().__dict__,
                                              **lm.SMALL}),
        base_dir=str(tmp_path), save_results=False, seed=0, adam_epochs=0,
        device="cpu", dtype=torch.float32, second_round="jax-bfgs",
        **arrays)
    tpb = td.train(epochs=5, callbacks=False)
    assert tpb.last_opt_state["kind"] == "bfgs_split"
    assert tpb.history.iters == jpb.history.iters
    assert lm._max_rel_dev(jpb.history, tpb.history) < SPLIT_BAR
    hi, lo = tpb.last_opt_state["carry"][:2]
    assert hi.dtype == lo.dtype == torch.float32
    assert bool((lo != 0).any())
    np.testing.assert_array_equal(
        tpb.last_theta64, hi.double().numpy() + lo.double().numpy())
    assert tpb.history.loss_global[-1] < tpb.history.loss_global[0]


# ---------------------------------------------------------------------------
# tpinn's lattice problem: both carries cross the float32 grid and resume
# ---------------------------------------------------------------------------

def _lattice_problem():
    """An optimum 8e-8 off the float32 lattice (tests/test_optimize_bfgs.py):
    no float32 parameter vector comes closer than about 8e-8."""
    model = TinyModel(torch.float32)
    x = torch.ones((4, 1), dtype=torch.float32)
    target64 = np.array([8e-8, -8e-8])
    t_hi = torch.as_tensor(target64.astype(np.float32))
    t_lo = torch.as_tensor((target64 - t_hi.double().numpy()).astype(
        np.float32))
    pb = OptimizationProblem(model.variables, [LossMeanSquares(
        "fit", lambda: (model(x) - t_hi) - t_lo)], [])
    return model, pb, target64


def _w64(theta64):
    """kernel + bias per output from a float64 vector in ravel order
    (bias, kernel)."""
    return theta64[2:4] + theta64[0:2]


_LATTICE = {"LM": (10, 1e-10), "BFGS": (80, 5e-9)}


@pytest.mark.parametrize("method", ["LM", "BFGS"])
def test_split_carry_navigates_below_the_f32_grid(method):
    iters, atol = _LATTICE[method]
    model, pb, target64 = _lattice_problem()
    minimize(pb, "jax", method, num_epochs=iters)
    assert pb.last_theta64.dtype == np.float64
    np.testing.assert_allclose(_w64(pb.last_theta64), target64, rtol=0,
                               atol=atol)
    # the float32 parameters alone cannot come that close
    w32 = _w64(pb.get_vector())
    assert np.abs(w32 - target64).max() > 10 * atol


def _restart(tmp_path, model, pb):
    path = tmp_path / "checkpoint.pkl"
    save_checkpoint(path, model.params, opt_state=pb.last_opt_state)
    ckpt = load_checkpoint(path)
    model2, pb2, _ = _lattice_problem()
    model2.set_params([{k: torch.as_tensor(np.asarray(p[k]))
                        for k in ("kernel", "bias")} for p in ckpt["params"]])
    pb2.resume_opt_state = ckpt["opt_state"]
    return model2, pb2


@pytest.mark.parametrize("method,first,second,kind", [
    ("LM", 4, 6, "lm"), ("BFGS", 40, 40, "bfgs_split")])
def test_split_carry_resumes_across_restart(tmp_path, method, first, second,
                                            kind):
    _, atol = _LATTICE[method]
    model, pb, target64 = _lattice_problem()
    minimize(pb, "jax", method, num_epochs=first)
    assert pb.last_opt_state["kind"] == kind
    model2, pb2 = _restart(tmp_path, model, pb)
    seen = []
    pb2.callbacks.append(lambda pb_, it, force=False: seen.append(
        pb_.last_opt_state))
    minimize(pb2, "jax", method, num_epochs=second)
    assert pb2.resume_opt_state is None
    assert seen[0] is not None and seen[0]["kind"] == kind
    np.testing.assert_allclose(_w64(pb2.last_theta64), target64, rtol=0,
                               atol=atol)
    # the same run without the restart: the same carry
    model3, pb3, _ = _lattice_problem()
    minimize(pb3, "jax", method, num_epochs=first + second)
    if method == "BFGS":
        np.testing.assert_array_equal(pb2.last_theta64, pb3.last_theta64)


def test_stale_split_carry_is_discarded():
    model, pb, _ = _lattice_problem()
    minimize(pb, "jax", "BFGS", num_epochs=20)
    stale = pb.last_opt_state
    model2, pb2, _ = _lattice_problem()  # fresh parameters: no match
    pb2.resume_opt_state = stale
    minimize(pb2, "jax", "BFGS", num_epochs=30)
    assert pb2.history.loss_global[-1] < 1e-9
    model3, pb3, _ = _lattice_problem()
    pb3.resume_opt_state = stale
    minimize(pb3, "jax", "LM", num_epochs=5)
    assert pb3.history.loss_global[-1] < 1e-9
    assert pb3.resume_opt_state is stale  # another kind: kept


# ---------------------------------------------------------------------------
# the opt-in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["LM", "BFGS"])
def test_opt_in_split_carries_raise_in_both_packages(tmp_path, monkeypatch,
                                                     method):
    monkeypatch.setenv("TPINN_USE_PALLAS", "1")
    jex = lm._jax_example()
    with _jax_f32():
        jd = lm._jax_driver(jex, tmp_path, second_round="lm", adam_epochs=0)
        jpb = jns.OptimizationProblem(jd.model.variables, jd.losses, [],
                                      callbacks=[])
        # jvp through the kernel: "safe_zip"; linearize: "Linearization"
        with pytest.raises(ValueError):
            jns.minimize(jpb, "jax", method, num_epochs=1)
    d = _driver32()
    pb = OptimizationProblem(d.model, d.losses, [])
    with pytest.raises(RuntimeError, match="kernel 5.*forward only"):
        minimize(pb, "jax", method, num_epochs=1)
