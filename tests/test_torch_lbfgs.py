"""The port's L-BFGS round, its zoom line search and the scheduled Adam
against optax and the JAX package, in float64 on the CPU (and float32 where
the dtypes of optax's scalars matter).

* the zoom line search (``tpinn_torch.linesearch``) against
  ``optax.scale_by_zoom_linesearch(max_linesearch_steps=30,
  initial_guess_strategy="one")`` on 1-D and n-D functions, with the
  failure paths (not a descent direction, no interval found, a non-finite
  region, every trial non-finite): the same step size at rtol 1e-12 after
  the same number of trials;
* the direction (``_scale_by_lbfgs``) against ``optax.scale_by_lbfgs`` over
  a sequence that wraps the ring (memory 3, 7 updates) at rtol 1e-13;
* the direction and the line search chained as ``optax.lbfgs`` in float32,
  where optax keeps the weights and some scalars in float64;
* the round against tpinn's ``minimize(pb, "jax", "L-BFGS")`` on the
  quadratic of tests/test_optimize_bfgs.py, on the Poiseuille driver at
  full width on small options (the data of tests/test_torch_lm.py, 20
  iterations, History logs within 1e-8 relative) and on the Poisson
  example's L-BFGS branch;
* a resumed L-BFGS round starts from the parameters alone, as in tpinn;
* ``cosine_decay_schedule`` and ``Adam`` on it against optax.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

import tpinn as jns
from tpinn_torch.cases import poisson
from tpinn_torch.driver import StandardNSDriver, run_second_round
from tpinn_torch.history import History
from tpinn_torch.linesearch import ScaleByZoomLinesearch
from tpinn_torch.optimize import LBFGSState, _scale_by_lbfgs, minimize
from tpinn_torch.optimizers import Adam, cosine_decay_schedule
from tpinn_torch.problem import OptimizationProblem
from tests import test_torch_bfgs as tb
from tests import test_torch_lm as lm
from tests import test_torch_poisson_case as pc

torch.set_num_threads(1)

HISTORY_BAR = 1e-8
ITERS = 20


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


# ---------------------------------------------------------------------------
# the zoom line search
# ---------------------------------------------------------------------------

def _functions(xp, where, nan, inf):
    """name -> (f, x0, direction sign): f(x) of a flat vector; the search
    runs along sign·∇f(x0)."""
    c = lambda n: xp.arange(1.0, n + 1.0)
    return {
        "quadratic": (lambda x: xp.sum(c(3) * (x - 0.3) ** 2),
                      [0.0, 0.0, 0.0], -1.0),
        "rosenbrock": (lambda x: xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                                        + (1.0 - x[:-1]) ** 2),
                       [-1.2, 1.0, 0.5], -1.0),
        "steep_zoom": (lambda x: xp.sum(1e4 * (x - 0.01) ** 2), [0.0], -1.0),
        "quartic": (lambda x: xp.sum((x - 1.7) ** 4 - 2.0 * x), [0.0], -1.0),
        "not_descent": (lambda x: xp.sum(c(3) * (x - 0.3) ** 2),
                        [0.0, 0.0, 0.0], 1.0),
        "interval_not_found": (lambda x: -xp.sum(x), [0.0, 0.0], -1.0),
        "nan_region": (lambda x: xp.sum(where(x > 0.6, nan, (x - 0.5) ** 2)),
                       [0.0], -1.0),
        "outside_domain": (lambda x: xp.sum(where(x > 1e-12, inf, -x)),
                           [0.0], -1.0),
    }


JAX_F = _functions(jnp, jnp.where, jnp.nan, jnp.inf)
TORCH_F = _functions(torch, torch.where, torch.nan, torch.inf)


def _torch_vg(f):
    def vg(x):
        x = x.detach().requires_grad_(True)
        v = f(x)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g
    return vg


def _optax_search(f, x0, sign, dtype):
    x = jnp.asarray(x0, dtype)
    v, g = jax.value_and_grad(f)(x)
    ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=30,
                                        initial_guess_strategy="one")
    _, st = ls.update(sign * g, ls.init(x), x, value=v, grad=g, value_fn=f)
    return st


def _port_search(f, x0, sign, dtype):
    x = torch.tensor(x0, dtype=dtype)
    vg = _torch_vg(f)
    v, g = vg(x)
    ls = ScaleByZoomLinesearch(30)
    _, st = ls.update(sign * g, ls.init(x), x, value=v, grad=g,
                      value_and_grad_fn=vg)
    return st


@pytest.mark.parametrize("name", list(JAX_F))
def test_linesearch_matches_optax(name):
    (fj, x0, sign), (ft, _, _) = JAX_F[name], TORCH_F[name]
    sj = _optax_search(fj, x0, sign, jnp.float64)
    st = _port_search(ft, x0, sign, torch.float64)
    assert st.num_linesearch_steps == int(sj.info.num_linesearch_steps)
    np.testing.assert_allclose(st.learning_rate.numpy(),
                               np.asarray(sj.learning_rate), rtol=1e-12)
    np.testing.assert_allclose(st.value.numpy(), np.asarray(sj.value),
                               rtol=1e-12)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(sj.grad),
                               rtol=1e-12, atol=1e-300)
    for key in ("decrease_error", "curvature_error"):
        np.testing.assert_allclose(getattr(st, key).numpy(),
                                   np.asarray(getattr(sj.info, key)),
                                   rtol=1e-12, atol=1e-300)
    assert st.value_nonfinite == (not np.isfinite(float(sj.value)))
    if name in ("not_descent", "interval_not_found", "outside_domain"):
        assert st.num_linesearch_steps == 30  # the search failed
    if name == "outside_domain":
        assert float(st.learning_rate) == 0.0
    if name == "steep_zoom":
        assert st.num_linesearch_steps > 3  # the zoom ran


@pytest.mark.parametrize("name", ["quadratic", "rosenbrock", "steep_zoom"])
def test_linesearch_float32_like_optax(name):
    (fj, x0, sign), (ft, _, _) = JAX_F[name], TORCH_F[name]
    sj = _optax_search(fj, x0, sign, jnp.float32)
    st = _port_search(ft, x0, sign, torch.float32)
    assert st.learning_rate.dtype == st.value.dtype == torch.float32
    assert st.num_linesearch_steps == int(sj.info.num_linesearch_steps)
    np.testing.assert_allclose(st.learning_rate.numpy(),
                               np.asarray(sj.learning_rate), rtol=1e-5)


# ---------------------------------------------------------------------------
# the direction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_direction_matches_optax_over_a_wrapped_ring(dtype):
    rng = np.random.default_rng(3)
    n, m = 6, 3
    tx = optax.scale_by_lbfgs(memory_size=m)
    p0 = rng.normal(size=n).astype(dtype)
    sj = tx.init(jnp.asarray(p0))
    st = LBFGSState(torch.tensor(p0), m)
    x = p0
    for k in range(7):
        g = rng.normal(size=n).astype(dtype)
        x = (x + 0.3 * rng.normal(size=n)).astype(dtype)
        uj, sj = tx.update(jnp.asarray(g), sj, jnp.asarray(x))
        ut = _scale_by_lbfgs(torch.tensor(g), st, torch.tensor(x))
        assert ut.dtype == getattr(torch, dtype)
        rtol = 1e-13 if dtype == "float64" else 1e-5
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(uj)).max())
    assert st.count == 7
    np.testing.assert_allclose(st.weights_memory.numpy(),
                               np.asarray(sj.weights_memory), rtol=1e-5)
    assert st.weights_memory.dtype == torch.float64


def test_float32_chain_matches_optax_lbfgs():
    """Direction and line search chained as optax.lbfgs, in float32, on a
    convex quartic in 6-D, both fed by one value and gradient (JAX's, so
    the function rounds alike): 15 iterations with the same trials and
    parameters within float32 rounding.  (XLA may contract a trial point
    x + η·d into one fused multiply-add, so the two drift by an ulp.)"""
    rng = np.random.default_rng(5)
    B = rng.normal(size=(6, 6))
    A = jnp.asarray(B @ B.T / 6 + 0.1 * np.eye(6), jnp.float32)

    def fj(x):
        return 0.5 * x @ (A @ x) + 0.25 * jnp.sum(x ** 4) - jnp.sum(x)

    opt = optax.lbfgs(memory_size=50, linesearch=optax.scale_by_zoom_linesearch(
        max_linesearch_steps=30, initial_guess_strategy="one"))
    x0 = np.linspace(-1.0, 2.0, 6).astype(np.float32)
    xj = jnp.asarray(x0)
    sj = opt.init(xj)
    vgj = optax.value_and_grad_from_state(fj)
    vg_jit = jax.jit(jax.value_and_grad(fj))

    def vg(x):
        v, g = vg_jit(jnp.asarray(x.numpy()))
        return torch.tensor(np.asarray(v)), torch.tensor(np.asarray(g))

    xt = torch.tensor(x0)
    lb = LBFGSState(xt, 50)
    ls = ScaleByZoomLinesearch(30)
    lst = ls.init(xt)
    for _ in range(15):
        v, g = vgj(xj, state=sj)
        u, sj = opt.update(g, sj, xj, value=v, grad=g, value_fn=fj)
        xj = optax.apply_updates(xj, u)
        vt, gt = vg(xt) if lst.value_nonfinite else (lst.value, lst.grad)
        d = -1.0 * _scale_by_lbfgs(gt, lb, xt)
        upd, lst = ls.update(d, lst, xt, value=vt, grad=gt,
                             value_and_grad_fn=vg)
        xt = xt + upd
        assert xt.dtype == lst.learning_rate.dtype == torch.float32
        assert lst.num_linesearch_steps == int(
            sj[-1].info.num_linesearch_steps)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the round against tpinn
# ---------------------------------------------------------------------------

def test_quadratic_round_like_tpinn():
    jm, jpb = tb._jax_tiny()
    jns.minimize(jpb, "jax", "L-BFGS", num_epochs=30)
    model, pb = tb._tiny_problem()
    minimize(pb, "jax", "L-BFGS", num_epochs=30)
    assert pb.history.round_names == jpb.history.round_names == ["jax_L-BFGS"]
    assert pb.history.iters == jpb.history.iters
    assert pb.history.loss_global[-1] < 1e-10
    a, b = np.array(jpb.history.loss_global), np.array(pb.history.loss_global)
    big = a > 1e-12  # above that, rounding of the converged tail dominates
    np.testing.assert_allclose(b[big], a[big], rtol=1e-10)
    assert pb.last_opt_state["kind"] == "lbfgs"
    assert pb.lbfgs_counts["iterations"] == 30
    # one evaluation to start, then the trials (the value and gradient the
    # search ends on are reused)
    assert pb.lbfgs_counts["evaluations"] == pb.lbfgs_counts["trials"] + 1
    # the timed round records its split and computes the same round
    model2, pb2 = tb._tiny_problem()
    minimize(pb2, "lbfgs", num_epochs=30, timed=True)
    assert pb2.history.loss_global == pb.history.loss_global
    assert len(pb2.lbfgs_times) == 30
    assert all(set(t) == {"direction", "evaluations"}
               for t in pb2.lbfgs_times)


@pytest.fixture(scope="module")
def poiseuille(tmp_path_factory):
    """tpinn's L-BFGS round through its driver on the small options."""
    tmp = tmp_path_factory.mktemp("lbfgs")
    jex = lm._jax_example()
    jd = lm._jax_driver(jex, tmp, second_round="jax", adam_epochs=0)
    arrays = lm._arrays(jd)
    jpb = jd.train(epochs=ITERS, callbacks=False)
    return {"arrays": arrays, "tmp": tmp, "jpb": jpb}


def test_poiseuille_round_matches_tpinn(poiseuille):
    td = lm._port_driver(poiseuille["arrays"], poiseuille["tmp"],
                         second_round="jax")
    tpb = td.train(epochs=ITERS, callbacks=False)
    h, hj = tpb.history, poiseuille["jpb"].history
    assert h.round_names == hj.round_names == ["keras_Adam", "jax_L-BFGS"]
    assert h.iters == hj.iters
    assert h.loss_global[-1] < 0.01 * h.loss_global[0]
    assert lm._max_rel_dev(hj, h) < HISTORY_BAR
    counts = tpb.lbfgs_counts
    assert counts["iterations"] == ITERS
    assert counts["evaluations"] == counts["trials"] + 1
    assert counts["trials"] >= ITERS


def test_scipy_with_lbfgs_method_routes_to_lbfgs(poiseuille):
    """"scipy" with a method other than BFGS runs the on-device L-BFGS, as
    in tpinn: the same round as "jax"."""
    td = lm._port_driver(poiseuille["arrays"], poiseuille["tmp"],
                         second_round="scipy", scipy_method="L-BFGS-B")
    tpb = td.train(epochs=ITERS, callbacks=False)
    assert tpb.history.round_names == ["keras_Adam", "jax_L-BFGS"]
    assert lm._max_rel_dev(poiseuille["jpb"].history, tpb.history) \
        < HISTORY_BAR


def test_poisson_lbfgs_branch_matches_example(tmp_path):
    jpb, _ = pc._example("poisson").main(
        ITERS, save_plots=False, second_round="jax",
        out_dir=str(tmp_path / "jax"))
    params, x_pde, x_test, edges, _ = pc._jax_draws()
    tpb, _ = poisson.from_arrays(x_pde, np.concatenate(edges), x_test,
                                 params, device="cpu")
    poisson.train(tpb, ITERS, second_round="jax")
    hj, ht = jpb.history, tpb.history
    assert ht.round_names == hj.round_names == ["keras_Adam", "jax_L-BFGS"]
    assert ht.iters == hj.iters
    assert pc._rel_devs(hj, ht, {1}) < pc.ADAM_BAR
    assert pc._rel_devs(hj, ht, {2}) < HISTORY_BAR
    assert ht.loss_global[-1] < ht.loss_global[ht.round_starts[1] // 10]


def test_resumed_round_restarts_from_the_parameters(poiseuille, tmp_path):
    """A run folder written by an L-BFGS round resumes from its parameters
    alone: the resumed round is a fresh L-BFGS round from the checkpointed
    parameters, and the checkpointed state stays unadopted."""
    arrays = poiseuille["arrays"]
    first = lm._port_driver(arrays, tmp_path / "a", second_round="jax")
    first.base_dir = str(tmp_path / "a")
    os.makedirs(first.base_dir)
    first.save_results = True
    first.train(epochs=10)
    first.save_experiment()
    folder = first.folder
    saved = first.pb.get_flat()

    again = lm._port_driver(arrays, tmp_path / "b", second_round="jax")
    pb = again.train(epochs=10, resume_from=folder)
    assert pb.history.round_names == ["keras_Adam", "jax_L-BFGS",
                                      "jax_L-BFGS"]
    assert pb.resume_opt_state["kind"] == "lbfgs"  # left for no round

    fresh = lm._port_driver(arrays, tmp_path / "c", second_round="none")
    pbf = OptimizationProblem(fresh.model, fresh.losses, fresh.losses_test)
    pbf.set_flat(saved)
    minimize(pbf, "jax", "L-BFGS", num_epochs=10)
    h = pb.history
    resumed = [v for v, r in zip(h.loss_global, h.rounds_idx) if r == 3]
    np.testing.assert_array_equal(resumed, pbf.history.loss_global)
    assert History.load(os.path.join(folder, "History_Loss.json")
                        ).round_names == pb.history.round_names


# ---------------------------------------------------------------------------
# the cosine schedule and the cosine Adam second round
# ---------------------------------------------------------------------------

def test_cosine_schedule_matches_optax():
    ref = optax.cosine_decay_schedule(1e-2, 37, alpha=1e-3)
    ours = cosine_decay_schedule(1e-2, 37, alpha=1e-3)
    for k in (0, 1, 5, 18, 36, 37, 50):
        np.testing.assert_allclose(ours(k), float(ref(jnp.asarray(
            k, jnp.int32))), rtol=1e-15)
    with pytest.raises(ValueError, match="decay_steps"):
        cosine_decay_schedule(1e-2, 0)


def test_scheduled_adam_matches_optax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(5, 5))
    A = A @ A.T + np.eye(5)
    b = rng.normal(size=5)
    x0 = rng.normal(size=5)
    opt = optax.adam(optax.cosine_decay_schedule(5e-2, 30, alpha=1e-3))
    xj = jnp.asarray(x0)
    st = opt.init(xj)
    grad = jax.jit(jax.grad(lambda x: 0.5 * x @ (jnp.asarray(A) @ x)
                            - jnp.asarray(b) @ x))
    xt = torch.tensor(x0)
    adam = Adam(cosine_decay_schedule(5e-2, 30, alpha=1e-3))
    adam.init([xt])
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for _ in range(40):  # past decay_steps: the rate stays at its floor
        u, st = opt.update(grad(xj), st, xj)
        xj = optax.apply_updates(xj, u)
        adam.step([xt], [At @ xt - bt])
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-13,
                               atol=1e-15)
    assert adam.step_count == 40


def test_adam_second_round_matches_tpinn(tmp_path):
    """run_second_round(pb, "adam", ...) in both packages: the cosine Adam
    round logged as keras_Adam, within the Adam bar."""
    from tpinn.driver import run_second_round as jax_run

    jex = lm._jax_example()
    jd = lm._jax_driver(jex, tmp_path, second_round="none", adam_epochs=0)
    jpb = jns.OptimizationProblem(jd.model.variables, jd.losses,
                                  jd.losses_test, callbacks=[])
    td = lm._port_driver(lm._arrays(jd), tmp_path, second_round="none")
    jax_run(jpb, "adam", 25, adam_lr=1e-2)
    tpb = OptimizationProblem(td.model, td.losses, td.losses_test)
    run_second_round(tpb, "adam", 25, adam_lr=1e-2)
    assert tpb.history.round_names == jpb.history.round_names \
        == ["keras_Adam"]
    assert tpb.history.iters == jpb.history.iters == [0, 10, 20, 25]
    assert lm._max_rel_dev(jpb.history, tpb.history) < 1e-10


def test_default_second_round_is_scipy(tmp_path):
    import inspect

    default = inspect.signature(StandardNSDriver).parameters["second_round"]
    assert default.default == "scipy"


if __name__ == "__main__":
    # The deviations behind the round bar above, per L-BFGS log point, on
    # the small options or (with "full") the reference ones, after ADAM
    # Adam epochs (default 0), from the repo root:
    #   JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
    #       python tests/test_torch_lbfgs.py [ITERS] [full] [ADAM]
    # With "perturb": how far the port's own Poiseuille run (the reference
    # options, seed 0, Adam 100, as chip_smoke.py phase 19 runs it) moves
    # per L-BFGS log point when θ after Adam is perturbed by 1e-15
    # relative, which bounds what rounding alone does to the round.
    import sys
    import tempfile

    jax.config.update("jax_enable_x64", True)
    if "perturb" in sys.argv[1:]:
        from tpinn_torch.cases import poiseuille_flow

        def perturbed_run(eps):
            with tempfile.TemporaryDirectory() as td:
                d = poiseuille_flow.main(td, adam_epochs=100, device="cpu",
                                         second_round="none")
            d.pb.callbacks.clear()
            x = d.pb.get_flat()
            gen = torch.Generator().manual_seed(1)
            d.pb.set_flat(x * (1 + eps * torch.randn(
                x.shape, generator=gen, dtype=x.dtype)))
            minimize(d.pb, "jax", "L-BFGS", num_epochs=40)
            return d.pb.history

        ha, hb = perturbed_run(0.0), perturbed_run(1e-15)
        for i, (r, it) in enumerate(zip(ha.rounds_idx, ha.iter_round)):
            if r == 2:
                sel = [j for j in range(i + 1) if ha.rounds_idx[j] == 2]
                print(f"  θ·(1 + 1e-15·N(0, 1)), up to L-BFGS iteration "
                      f"{it}: {max(pc._rel_devs_at(ha, hb, sel)):.3e}")
        sys.exit(0)
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else ITERS
    full = "full" in sys.argv[2:]
    adam = int(([a for a in sys.argv[2:] if a.isdigit()] or ["0"])[0])
    if full:
        lm.SMALL = dict(epochs=iters)
    with threadpool_limits(limits=1, user_api="blas"), \
            tempfile.TemporaryDirectory() as td:
        jd = lm._jax_driver(lm._jax_example(), td, second_round="jax",
                            adam_epochs=adam)
        arrays = lm._arrays(jd)
        hj = jd.train(epochs=iters, callbacks=False).history
        drv = lm._port_driver(arrays, td, second_round="jax")
        drv.adam_epochs = adam
        tpb = drv.train(epochs=iters, callbacks=False)
        h = tpb.history
        print(f"Poiseuille Adam {adam} + jax_L-BFGS {iters} "
              f"({'reference' if full else 'small'} options): loss_global "
              f"{hj.loss_global[-1]!r} (tpinn), {h.loss_global[-1]!r} "
              f"(port); Adam part {pc._rel_devs(hj, h, {1}):.3e}; "
              f"{tpb.lbfgs_counts}")
        for i, (r, it) in enumerate(zip(hj.rounds_idx, hj.iter_round)):
            if r == 2:
                sel = [j for j in range(i + 1) if hj.rounds_idx[j] == 2]
                print(f"  up to iteration {it}: max rel deviation of every "
                      f"log {max(pc._rel_devs_at(hj, h, sel)):.3e}")
