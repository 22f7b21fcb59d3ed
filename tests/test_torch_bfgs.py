"""The port's dense BFGS round against the JAX package's, in float64 on the
CPU.

* the line search: ``_wolfe_zoom_linesearch`` on 1-D functions (a quadratic,
  a quartic, a bracket that needs halving, an upward slope, a NaN region
  past the minimum and a NaN region that no trial passes) returns the same
  (alpha, φ(alpha)) bit for bit;
* the update: ``_bfgs_update_H`` over every (safe, first, failed)
  combination at rtol 1e-13 (entries within 1e-13 of the largest count as
  equal: the products sum in another order);
* one step of each variant from a shared carry (a non-identity H adopted
  as a resumed state by both packages): x, f and g at rtol 1e-12;
* the rounds on the JAX package's own BFGS problems
  (tests/test_optimize_bfgs.py: the quadratic, the pedestal in float64, the
  fallback without residual vectors, a region where the gradient is NaN);
* the Poiseuille driver at full width on small options (the sizes of
  tests/test_torch_lm.py), from tpinn's data through ``from_arrays``: the
  plain variant (the port's fused objective against tpinn's value and
  gradient with the PDE losses given as scalar losses) and the paired
  variant (``TPINN_USE_PALLAS=0`` in the port, tpinn's residual losses),
  History logs within 1e-8 relative over 20 iterations (PERF.md section 2;
  measured about 3e-13);
* the Poisson case's "jax-bfgs" round against the example at the same bar;
* the variant each package picks (float32 with residual losses: the
  split carry), and the variant that raises in both packages: a round
  under ``TPINN_USE_PALLAS=1`` (its Taylor-bundle kernel has no reverse
  mode).

tpinn compiles each BFGS scan afresh, so its reference rounds run once per
module (the ``poiseuille`` and ``poisson`` fixtures).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tpinn as jns
from tpinn.optimize import _bfgs_update_H as jax_update
from tpinn.optimize import _wolfe_zoom_linesearch as jax_linesearch
from tpinn_torch import config
from tpinn_torch.cases import poisson
from tpinn_torch.losses import Loss, LossMeanSquares
from tpinn_torch.models import Model
from tpinn_torch.optimize import _bfgs_update_H, _wolfe_zoom_linesearch
from tpinn_torch.optimize import minimize
from tpinn_torch.problem import OptimizationProblem
from tests import test_torch_lm as lm
from tests import test_torch_poisson_case as pc

torch.set_num_threads(1)

HISTORY_BAR = 1e-8
ITERS = 20


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread, as torch.set_num_threads(1) gives one intra-op
    thread: tier-1 runs six workers."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


# ---------------------------------------------------------------------------
# the line search and the update
# ---------------------------------------------------------------------------

def _phi(xp, where, nan):
    """The 1-D test functions, written once for both array modules:
    a -> (φ(a), φ'(a))."""
    return {
        "quadratic": lambda a: (3.0 * (a - 0.3) ** 2 + 1.0, 6.0 * (a - 0.3)),
        "quartic": lambda a: ((a - 1.7) ** 4 - 2.0 * a,
                              4.0 * (a - 1.7) ** 3 - 2.0),
        "halving": lambda a: (100.0 * (a - 0.01) ** 2, 200.0 * (a - 0.01)),
        "upward": lambda a: (2.0 * a + 1.0, 2.0 + 0.0 * a),
        "nan_past_minimum": lambda a: (
            where(a > 0.6, nan, (a - 0.5) ** 2),
            where(a > 0.6, nan, 2.0 * (a - 0.5))),
        "nan_no_accept": lambda a: (where(a > 0.3, nan, -a),
                                    where(a > 0.3, nan, -1.0 + 0.0 * a)),
    }


JAX_PHI = _phi(jnp, jnp.where, jnp.nan)
TORCH_PHI = _phi(torch, torch.where, torch.nan)


@pytest.mark.parametrize("name", list(JAX_PHI))
def test_linesearch_matches_tpinn_bit_for_bit(name):
    fj, ft = JAX_PHI[name], TORCH_PHI[name]
    f0j, g0j = fj(jnp.float64(0.0))
    f0t, g0t = ft(torch.tensor(0.0, dtype=torch.float64))
    aj, vj = jax_linesearch(fj, jnp.asarray(f0j, jnp.float64),
                            jnp.asarray(g0j, jnp.float64))
    at, vt = _wolfe_zoom_linesearch(ft, f0t, g0t)
    assert at.dtype == vt.dtype == torch.float64
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    if name == "upward":  # no descent: the best trial is alpha = 0
        assert float(at) == 0.0
    if name == "nan_no_accept":  # the best finite trial, below the NaNs
        assert 0.25 <= float(at) <= 0.3


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("failed", [True, False])
def test_update_matches_tpinn(safe, first, failed):
    rng = np.random.default_rng(7)
    n = 9
    A = rng.normal(size=(n, n))
    H = A @ A.T / n + np.eye(n)
    s = rng.normal(size=n)
    y = s + 0.3 * rng.normal(size=n)
    if not safe:
        y = -y
    Hj, fj = jax_update(jnp.asarray(H), jnp.asarray(s), jnp.asarray(y),
                        jnp.array(first), jnp.array(failed), n, jnp.float64)
    Ht, ft = _bfgs_update_H(torch.tensor(H), torch.tensor(s),
                            torch.tensor(y), torch.tensor(first),
                            torch.tensor(failed))
    Hj = np.asarray(Hj)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-13,
                               atol=1e-13 * np.abs(Hj).max())
    assert bool(ft) == bool(fj) == ((first and not safe) or failed)
    if failed:
        np.testing.assert_array_equal(Ht.numpy(), np.eye(n))
    elif not safe:  # the pair is dropped: H (first never scales here)
        np.testing.assert_array_equal(Ht.numpy(), H)


# ---------------------------------------------------------------------------
# one step from a shared carry
# ---------------------------------------------------------------------------

def _mlp_pair(plain: bool):
    """A 2-6-6-1 tanh MLP fitting sin(3x)·cos(2y) on 40 points in both
    packages from tpinn's θ0; with ``plain`` a scalar loss (the squared
    mean output) joins, so both take the plain variant."""
    from tpinn.models import Model as JaxModel

    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (40, 2))
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
    jm = JaxModel([2, 6, 6, 1], seed=3)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    j_losses = [jns.LossMeanSquares("fit", lambda: jm(jx)[:, 0] - jy)]
    tm = Model([2, 6, 6, 1], device="cpu")
    tm.set_params([{k: torch.tensor(np.asarray(p[k])) for k in p}
                   for p in jm.params])
    tx, ty = torch.tensor(x), torch.tensor(y)
    t_losses = [LossMeanSquares("fit", lambda: tm(tx)[:, 0] - ty)]
    if plain:
        j_losses.append(jns.Loss("gauge", lambda: jnp.mean(jm(jx)) ** 2))
        t_losses.append(Loss("gauge", lambda: torch.mean(tm(tx)) ** 2))
    jpb = jns.OptimizationProblem(jm.variables, j_losses, [])
    tpb = OptimizationProblem(tm.variables, t_losses, [])
    return jm, jpb, tm, tpb


@pytest.mark.parametrize("plain", [True, False])
def test_one_step_from_shared_carry(plain):
    from jax.flatten_util import ravel_pytree

    jm, jpb, tm, tpb = _mlp_pair(plain)
    x0, unravel = ravel_pytree(jm.params)
    n = x0.shape[0]
    rng = np.random.default_rng(11)
    A = rng.normal(size=(n, n))
    H = 0.05 * (np.eye(n) + A @ A.T / n)
    if plain:
        f0, g0 = jax.value_and_grad(lambda x: jpb.loss_fn(unravel(x)))(x0)
        carry = (np.asarray(x0), np.asarray(f0), np.asarray(g0), H,
                 np.array(False))
        kind = "bfgs_plain"
    else:
        from tpinn.optimize import _flat_residual_fn

        _, _, res = _flat_residual_fn(jpb)
        r0, vjp = jax.vjp(res, x0)
        g0 = vjp(2.0 * r0)[0]
        carry = (np.asarray(x0), np.asarray(jnp.dot(r0, r0)),
                 np.asarray(r0), np.asarray(g0), H, np.array(False))
        kind = "bfgs_paired"
    jpb.resume_opt_state = {"kind": kind, "carry": carry}
    tpb.resume_opt_state = {"kind": kind, "carry": carry}
    jns.minimize(jpb, "jax", "BFGS", num_epochs=1)
    minimize(tpb, "jax", "BFGS", num_epochs=1)
    assert str(jpb.last_opt_state["kind"]) == tpb.last_opt_state["kind"] == kind
    assert jpb.resume_opt_state is None and tpb.resume_opt_state is None
    cj, ct = jpb.last_opt_state["carry"], tpb.last_opt_state["carry"]
    i_g = 2 if plain else 3
    for i in (0, 1, i_g):  # x, f, g
        ref = np.asarray(cj[i])
        np.testing.assert_allclose(ct[i].numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
    assert not np.array_equal(np.asarray(cj[0]), carry[0])  # it stepped


# ---------------------------------------------------------------------------
# the JAX package's BFGS problems
# ---------------------------------------------------------------------------

class TinyModel(Model):
    """The 2-parameter linear model of tests/test_optimize_bfgs.py."""

    def __init__(self, dtype=torch.float64):
        super().__init__([1, 2], device="cpu", dtype=dtype)
        self.set_params([{"kernel": torch.tensor([[5.0, -3.0]]),
                          "bias": torch.zeros(2)}])

    def apply(self, params, x):
        return x @ params[0]["kernel"] + params[0]["bias"]


def _tiny_problem(extra=(), residual=None, dtype=torch.float64):
    """The quadratic fit of tests/test_optimize_bfgs.py; ``residual(model,
    x, target)`` replaces model(x) − target."""
    model = TinyModel(dtype)
    x = torch.ones((4, 1), dtype=dtype)
    target = torch.tensor([2.0, 7.0], dtype=dtype)
    residual = residual or (lambda m, x_, t: m(x_) - t)
    fit = LossMeanSquares("fit", lambda: residual(model, x, target))
    return model, OptimizationProblem(model.variables, [fit, *extra], [])


def _kernel_plus_bias(model):
    p = model.params[0]
    return (p["kernel"][0] + p["bias"]).detach().numpy()


def _jax_tiny(**kw):
    from tests.test_optimize_bfgs import _make_problem

    return _make_problem(**kw)


def test_quadratic_round_like_tpinn():
    jm, jpb = _jax_tiny()
    jns.minimize(jpb, "jax", "BFGS", num_epochs=30)
    model, pb = _tiny_problem()
    minimize(pb, "jax", "BFGS", num_epochs=30)
    assert pb.history.round_names == ["jax_BFGS"]
    assert pb.last_opt_state["kind"] == str(jpb.last_opt_state["kind"])
    assert pb.history.loss_global[-1] < 1e-12
    np.testing.assert_allclose(_kernel_plus_bias(model), [2.0, 7.0],
                               atol=1e-5)
    assert pb.history.iters == jpb.history.iters
    np.testing.assert_allclose(pb.history.loss_global[:2],
                               jpb.history.loss_global[:2], rtol=1e-12)
    # the timed round records its split and computes the same round
    model2, pb2 = _tiny_problem()
    minimize(pb2, "jax", "BFGS", num_epochs=30, timed=True)
    assert pb2.history.loss_global == pb.history.loss_global
    assert len(pb2.bfgs_times) == 30
    assert all(set(t) == {"direction", "evaluations", "update"}
               for t in pb2.bfgs_times)
    assert pb.bfgs_times == []


def test_pedestal_round_float64_like_tpinn():
    """The pedestal problem (a 1e4 constant under a ~1e-7 informative part)
    in float64, where both packages take the paired variant."""
    from tests.test_optimize_bfgs import TinyModel as JaxTinyModel

    jm = JaxTinyModel()
    jx = jnp.ones((4, 1))
    jt = jnp.array([2.0, 7.0])
    jpb = jns.OptimizationProblem(jm.variables, [
        jns.LossMeanSquares("fit", lambda: 1e-4 * (jm(jx) - jt)),
        jns.LossMeanSquares("pedestal", lambda: jnp.full((1,), 100.0))], [])
    jns.minimize(jpb, "jax", "BFGS", num_epochs=60)

    model = TinyModel()
    x = torch.ones((4, 1), dtype=torch.float64)
    t = torch.tensor([2.0, 7.0], dtype=torch.float64)
    pb = OptimizationProblem(model.variables, [
        LossMeanSquares("fit", lambda: 1e-4 * (model(x) - t)),
        LossMeanSquares("pedestal", lambda: torch.full(
            (1,), 100.0, dtype=torch.float64))], [])
    minimize(pb, "jax", "BFGS", num_epochs=60)
    assert (pb.last_opt_state["kind"] == str(jpb.last_opt_state["kind"])
            == "bfgs_paired")
    np.testing.assert_allclose(_kernel_plus_bias(model), [2.0, 7.0],
                               atol=2e-3)
    kj = np.asarray(jm.params[0]["kernel"])[0] + np.asarray(
        jm.params[0]["bias"])
    np.testing.assert_allclose(_kernel_plus_bias(model), kj, atol=1e-6)


def test_fallback_without_residual_vectors_like_tpinn():
    jm, jpb = _jax_tiny()
    jpb.losses.append(jns.Loss("gauge", lambda: jnp.array(0.0)))
    jns.minimize(jpb, "jax", "BFGS", num_epochs=30)
    model, pb = _tiny_problem(extra=[Loss("gauge", lambda: torch.tensor(
        0.0, dtype=torch.float64))])
    minimize(pb, "jax", "BFGS", num_epochs=30)
    assert (pb.last_opt_state["kind"] == str(jpb.last_opt_state["kind"])
            == "bfgs_plain")
    np.testing.assert_allclose(_kernel_plus_bias(model), [2.0, 7.0],
                               atol=1e-4)
    np.testing.assert_allclose(pb.history.loss_global[:2],
                               jpb.history.loss_global[:2], rtol=1e-12)


def test_survives_nonfinite_trial_region():
    """The gradient is NaN outside a ball while the loss stays finite: the
    round rejects such steps instead of folding them into the carry."""

    def shell_residual(model, x, target):
        u = model(x)
        mag = torch.sum(u ** 2)
        return u - target + torch.sqrt(torch.clamp(64.0 - mag, min=0.0)) * 1e-3

    model, pb = _tiny_problem(residual=shell_residual)
    minimize(pb, "jax", "BFGS", num_epochs=40)
    assert np.isfinite(pb.history.loss_global[-1])
    assert all(torch.isfinite(t).all() for t in pb.params)
    x, f, r, g, H, first = pb.last_opt_state["carry"]
    assert all(bool(torch.isfinite(t).all()) for t in (x, f, r, g, H))
    assert pb.history.loss_global[-1] < pb.history.loss_global[0]


# ---------------------------------------------------------------------------
# the Poiseuille driver and the Poisson case against tpinn
# ---------------------------------------------------------------------------

def _wrapped_plain(jd):
    """tpinn's problem on the driver's losses with the PDE losses given as
    scalar losses, so that tpinn takes the plain variant."""
    losses = [jns.Loss(l.name, l.raw_value, weight=l.weight)
              if l.name.startswith("PDE") else l for l in jd.losses]
    return jns.OptimizationProblem(jd.model.variables, losses,
                                   jd.losses_test, callbacks=[])


@pytest.fixture(scope="module")
def poiseuille(tmp_path_factory):
    """tpinn's two BFGS rounds on the small options: the paired variant
    through its driver, the plain one on scalar PDE losses."""
    tmp = tmp_path_factory.mktemp("bfgs")
    jex = lm._jax_example()
    jd = lm._jax_driver(jex, tmp, second_round="jax-bfgs", adam_epochs=0)
    arrays = lm._arrays(jd)
    paired = jd.train(epochs=ITERS, callbacks=False)
    jd2 = lm._jax_driver(jex, tmp, second_round="jax-bfgs", adam_epochs=0)
    plain = _wrapped_plain(jd2)
    jns.minimize(plain, "keras", jns.optimizers.Adam(learning_rate=1e-2),
                 num_epochs=0)
    jns.minimize(plain, "jax", "BFGS", num_epochs=ITERS)
    return {"arrays": arrays, "tmp": tmp, "jex": jex,
            "bfgs_paired": paired, "bfgs_plain": plain}


def _port_round(arrays, tmp, use_pallas=None):
    env = os.environ.pop("TPINN_USE_PALLAS", None)
    if use_pallas is not None:
        os.environ["TPINN_USE_PALLAS"] = use_pallas
    try:
        td = lm._port_driver(arrays, tmp, second_round="jax-bfgs")
        return td.train(epochs=ITERS, callbacks=False)
    finally:
        os.environ.pop("TPINN_USE_PALLAS", None)
        if env is not None:
            os.environ["TPINN_USE_PALLAS"] = env


@pytest.mark.parametrize("kind,use_pallas", [("bfgs_plain", None),
                                             ("bfgs_paired", "0")])
def test_poiseuille_round_matches_tpinn(poiseuille, kind, use_pallas):
    ref = poiseuille[kind]
    tpb = _port_round(poiseuille["arrays"], poiseuille["tmp"], use_pallas)
    assert tpb.last_opt_state["kind"] == str(ref.last_opt_state["kind"]) == kind
    h, hj = tpb.history, ref.history
    assert h.round_names == hj.round_names == ["keras_Adam", "jax_BFGS"]
    assert h.iters == hj.iters
    assert h.loss_global[-1] < 0.01 * h.loss_global[0]
    assert lm._max_rel_dev(hj, h) < HISTORY_BAR
    counts = tpb.bfgs_counts
    assert counts["iterations"] == ITERS
    # per iteration: the trials, the re-evaluation and the new point's value
    # and gradient; one more for the first carry
    assert counts["evaluations"] == counts["trials"] + 2 * ITERS + 1
    np.testing.assert_array_equal(tpb.last_opt_state["carry"][0].numpy(),
                                  tpb.get_vector())


@pytest.fixture(scope="module")
def poisson_ref(tmp_path_factory):
    jpb, _ = pc._example("poisson").main(
        ITERS, save_plots=False, second_round="jax-bfgs",
        out_dir=str(tmp_path_factory.mktemp("poisson")))
    return jpb


def test_poisson_bfgs_matches_example(poisson_ref):
    params, x_pde, x_test, edges, _ = pc._jax_draws()
    tpb, _ = poisson.from_arrays(x_pde, np.concatenate(edges), x_test,
                                 params, device="cpu")
    poisson.train(tpb, ITERS, second_round="jax-bfgs")
    hj, ht = poisson_ref.history, tpb.history
    assert ht.round_names == hj.round_names == ["keras_Adam", "jax_BFGS"]
    assert ht.iters == hj.iters
    # on the CPU the example takes its tape path (paired), the port its fused
    # objective's plain twin (plain), as with the L-BFGS-B round
    assert str(poisson_ref.last_opt_state["kind"]) == "bfgs_paired"
    assert tpb.last_opt_state["kind"] == "bfgs_plain"
    assert pc._rel_devs(hj, ht, {1}) < pc.ADAM_BAR
    assert pc._rel_devs(hj, ht, {2}) < HISTORY_BAR
    assert ht.loss_global[-1] < ht.loss_global[ht.round_starts[1] // 10]


# ---------------------------------------------------------------------------
# the variants that raise
# ---------------------------------------------------------------------------

def test_float32_residual_losses_raise_naming_the_split_item():
    """float32 residual losses take the split carry (``bfgs_split``, as in
    tpinn); its parity is in tests/test_torch_split.py."""
    model, pb = _tiny_problem(dtype=torch.float32)
    minimize(pb, "jax", "BFGS", num_epochs=30)
    assert pb.history.round_names == ["jax_BFGS"]
    assert pb.last_opt_state["kind"] == "bfgs_split"
    assert len(pb.last_opt_state["carry"]) == 8
    assert pb.last_theta64.dtype == np.float64
    np.testing.assert_allclose(_kernel_plus_bias(model), [2.0, 7.0],
                               atol=1e-4)
    # a scalar loss in the mix: the plain variant runs in float32
    model, pb = _tiny_problem(dtype=torch.float32, extra=[
        Loss("gauge", lambda: torch.tensor(0.0))])
    minimize(pb, "jax", "BFGS", num_epochs=10)
    assert pb.last_opt_state["kind"] == "bfgs_plain"
    assert pb.last_opt_state["carry"][0].dtype == torch.float32
    assert pb.history.loss_global[-1] < 1e-3 * pb.history.loss_global[0]


def test_opt_in_round_raises_in_both_packages(poiseuille, monkeypatch):
    monkeypatch.setenv("TPINN_USE_PALLAS", "1")
    jd = lm._jax_driver(poiseuille["jex"], poiseuille["tmp"],
                        second_round="jax-bfgs", adam_epochs=0)
    jpb = jns.OptimizationProblem(jd.model.variables, jd.losses, [])
    with pytest.raises(ValueError, match="reverse-mode"):
        jns.minimize(jpb, "jax", "BFGS", num_epochs=1)
    td = lm._port_driver(poiseuille["arrays"], poiseuille["tmp"],
                         second_round="jax-bfgs")
    tpb = OptimizationProblem(td.model, td.losses, [])
    with pytest.raises(RuntimeError, match="TPINN_USE_PALLAS"):
        minimize(tpb, "jax", "BFGS", num_epochs=1)


def test_round_restores_the_float32_product_setting():
    model, pb = _tiny_problem()
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("high")
    try:
        seen = []
        pb.callbacks.append(lambda pb_, it, force=False: seen.append(
            torch.get_float32_matmul_precision()))
        minimize(pb, "jax", "BFGS", num_epochs=3)
        assert set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before[1])
        torch.backends.cuda.matmul.allow_tf32 = before[0]
    assert config.get_dtype() == torch.float64


if __name__ == "__main__":
    # The deviations behind the round bars above, from the repo root:
    #   JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
    #       python tests/test_torch_bfgs.py
    import tempfile

    jax.config.update("jax_enable_x64", True)
    with threadpool_limits(limits=1, user_api="blas"), \
            tempfile.TemporaryDirectory() as td:
        from pathlib import Path

        class _Factory:
            def mktemp(self, name):
                p = Path(td) / name
                p.mkdir()
                return p

        refs = poiseuille.__wrapped__(_Factory())
        for kind, pallas in (("bfgs_plain", None), ("bfgs_paired", "0")):
            tpb = _port_round(refs["arrays"], refs["tmp"], pallas)
            print(f"Poiseuille {kind}, {ITERS} iterations: loss_global "
                  f"{refs[kind].history.loss_global[-1]!r} (tpinn), "
                  f"{tpb.history.loss_global[-1]!r} (port); max rel "
                  f"deviation of every log "
                  f"{lm._max_rel_dev(refs[kind].history, tpb.history):.3e}; "
                  f"{tpb.bfgs_counts}")
        jpb = poisson_ref.__wrapped__(_Factory())
        params, x_pde, x_test, edges, _ = pc._jax_draws()
        tpb, _ = poisson.from_arrays(x_pde, np.concatenate(edges), x_test,
                                     params, device="cpu")
        poisson.train(tpb, ITERS, second_round="jax-bfgs")
        print(f"Poisson jax-bfgs, {ITERS} iterations: max rel deviation "
              f"{pc._rel_devs(jpb.history, tpb.history, {2}):.3e}")
