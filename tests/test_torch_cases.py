"""The port's colliding-flow and Poiseuille-variant cases against the JAX
package's examples, in float64 on the CPU.

* the colliding-flow oracle against tpinn's at rtol 1e-15;
* the colliding-flow driver (``tpinn_torch.cases.colliding_flow``) on
  small options, from tpinn's data through ``from_arrays``: its loss names
  (``Fit_p`` as in tpinn), every loss at θ0 within 1e-12, and 20 Adam
  epochs then 10 iterations of the default "scipy" round (the dense BFGS)
  against tpinn's History logs (Adam within 1e-10, the second round within
  1e-8); with ``pressure_gauge="mean"`` a ``PRESS_0`` loss at tpinn's
  value, on the pressure split and, without one, on the PDE batch;
* the Poiseuille variant without inflow conditions (its loss names and a
  short history against tpinn's);
* the three hand-rolled scripts (colliding flow with the mean-pressure
  gauge, Poiseuille without pressure, dimensionless Poiseuille) from
  tpinn's θ0 and ``jax.random`` points carried across: every loss at θ0
  within 1e-12, then 100 Adam epochs and 5 L-BFGS iterations within the
  same bars;
* an LM round on a problem with ``PRESS_0`` raises as in tpinn.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tpinn as jns
from tpinn.geometry import generate_noise as jax_noise
from tpinn.geometry import sample_box as jax_box
from tpinn.models import MLP as JaxMLP
from tpinn.oracles import analytic as jax_analytic
from tpinn_torch.cases import (colliding_flow, colliding_flow_pressmean,
                               poiseuille_adimensional, poiseuille_no_bcs,
                               poiseuille_no_pressure)
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import StandardNSDriver
from tpinn_torch.losses import Loss, PrecomputedMeanSquares
from tpinn_torch.optimize import minimize
from tpinn_torch.oracles import analytic
from tpinn_torch.problem import OptimizationProblem
from tests import test_torch_lm as lm
from tests import test_torch_poisson_case as pc

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAM_BAR = 1e-10
ROUND_BAR = 1e-8
THETA0_BAR = 1e-12
SMALL = dict(epochs=10, n_pde=30, n_bc=8, n_vel=4, n_pres=1, n_test=20)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _example(folder, name):
    path = os.path.join(_REPO, "examples", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{name}_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _theta0_dev(hj, ht):
    """Largest relative deviation of every loss at the first log point."""
    return max(pc._rel_devs_at(hj, ht, [0]))


# ---------------------------------------------------------------------------
# the colliding-flow oracle and driver
# ---------------------------------------------------------------------------

def test_colliding_oracle_matches_tpinn():
    x = np.random.default_rng(0).uniform(-1.0, 1.0, (200, 2))
    xt = torch.as_tensor(x)
    for name in ("colliding_u", "colliding_v", "colliding_p"):
        ref = np.asarray(getattr(jax_analytic, name)(jnp.asarray(x)))
        got = getattr(analytic, name)(xt).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-15, atol=1e-13)
    # the exact solution is divergence free
    u, v = analytic.colliding_u, analytic.colliding_v
    xt = xt.clone().requires_grad_(True)
    du = torch.autograd.grad(u(xt).sum(), xt)[0][:, 0]
    dv = torch.autograd.grad(v(xt).sum(), xt)[0][:, 1]
    np.testing.assert_allclose((du + dv).detach().numpy(), 0.0, atol=1e-12)


def _jax_driver(jex, tmp, opts=None, **kw):
    from tpinn.config import SimulationOptions as JaxOptions
    from tpinn.driver import StandardNSDriver as JaxDriver

    spec = jex.build_spec()
    gauge = kw.pop("pressure_gauge", None)
    if gauge is not None:
        spec.pressure_gauge = gauge
    opts = JaxOptions(**{**jex.default_options().__dict__, **(opts or SMALL)})
    return JaxDriver(spec, opts, base_dir=str(tmp), save_results=False,
                     seed=0, **kw)


def _port_driver(case, arrays, tmp, opts=None, pressure_gauge=None, **kw):
    spec = case.build_spec()
    if pressure_gauge is not None:
        spec.pressure_gauge = pressure_gauge
    opts = SimulationOptions(**{**case.default_options().__dict__,
                                **(opts or SMALL)})
    return StandardNSDriver.from_arrays(
        spec, opts, base_dir=str(tmp), save_results=False, seed=0,
        device="cpu", **arrays, **kw)


@pytest.fixture(scope="module")
def colliding(tmp_path_factory):
    """tpinn's colliding-flow driver on the small options: 20 Adam epochs,
    then 10 iterations of its default "scipy" round."""
    tmp = tmp_path_factory.mktemp("colliding")
    jex = _example("Colliding_Flow", "colliding_flow")
    jd = _jax_driver(jex, tmp, adam_epochs=20)
    arrays = lm._arrays(jd)
    jpb = jd.train(callbacks=False)
    return {"jex": jex, "arrays": arrays, "tmp": tmp, "jpb": jpb}


def test_colliding_driver_matches_tpinn(colliding):
    td = _port_driver(colliding_flow, colliding["arrays"], colliding["tmp"],
                      adam_epochs=20)
    names = [l.name for l in td.losses]
    assert names == list(colliding["jpb"].history.losses)
    assert names[-3:] == ["Fit_u", "Fit_v", "Fit_p"]
    assert all(n.startswith("BCD_") for n in names[3:11])
    assert all(isinstance(l, PrecomputedMeanSquares) for l in td.losses[:3])
    assert td.spec.physics.conv == 1.0 / 40.0
    assert td.second_round == "scipy"
    tpb = td.train(callbacks=False)
    hj, ht = colliding["jpb"].history, tpb.history
    assert ht.round_names == hj.round_names == ["keras_Adam", "jax_BFGS"]
    assert ht.iters == hj.iters
    assert _theta0_dev(hj, ht) < THETA0_BAR
    assert pc._rel_devs(hj, ht, {1}) < ADAM_BAR
    assert pc._rel_devs(hj, ht, {2}) < ROUND_BAR
    assert ht.loss_global[-1] < ht.loss_global[0]
    # a dense BFGS round with PRESS_0 takes the plain variant; here the
    # fused objective does
    assert tpb.last_opt_state["kind"] == "bfgs_plain"


@pytest.mark.parametrize("n_pres", [1, 0])
def test_pressure_mean_gauge_matches_tpinn(colliding, n_pres):
    """PRESS_0 = |mean p| with weight 1e-2, on the pressure split or, when
    it is empty, on the PDE batch; no Fit_p."""
    opts = {**SMALL, "n_pres": n_pres}
    jd = _jax_driver(colliding["jex"], colliding["tmp"], opts=opts,
                     pressure_gauge="mean", adam_epochs=0)
    td = _port_driver(colliding_flow, lm._arrays(jd), colliding["tmp"],
                      opts=opts, pressure_gauge="mean", adam_epochs=0)
    assert [l.name for l in td.losses] == [l.name for l in jd.losses]
    jl, tl = jd.losses[-1], td.losses[-1]
    assert tl.name == jl.name == "PRESS_0" and type(tl) is Loss
    assert tl.weight == jl.weight == 1e-2 and tl.non_negative
    assert "Fit_p" not in [l.name for l in td.losses]
    with torch.no_grad():
        got = float(tl.raw_value())
    np.testing.assert_allclose(got, float(jl.raw_value()), rtol=THETA0_BAR)
    assert got > 0.0


def test_lm_with_pressure_gauge_raises_as_in_tpinn(colliding):
    """PRESS_0 is a scalar loss with no residual vector: the LM round
    refuses it in both packages before any step."""
    jd = _jax_driver(colliding["jex"], colliding["tmp"],
                     pressure_gauge="mean", adam_epochs=0,
                     second_round="lm")
    jpb = jns.OptimizationProblem(jd.model.variables, jd.losses, [])
    with pytest.raises(ValueError, match="LossMeanSquares"):
        jns.minimize(jpb, "jax", "LM", num_epochs=1)
    td = _port_driver(colliding_flow, lm._arrays(jd), colliding["tmp"],
                      pressure_gauge="mean", adam_epochs=0,
                      second_round="lm")
    pb = OptimizationProblem(td.model, td.losses, [])
    with pytest.raises(ValueError, match="LossMeanSquares.*PRESS_0"):
        minimize(pb, "jax", "LM", num_epochs=1)
    assert pb.history.round_names == []


def test_poiseuille_no_bcs_matches_tpinn(tmp_path):
    jex = _example("Poiseuille_Flow", "poiseuille_no_bcs")
    opts = {**SMALL, "n_pres": 0, "n_vel": 6}
    jd = _jax_driver(jex, tmp_path, opts=opts, adam_epochs=10,
                     second_round="jax")
    arrays = lm._arrays(jd)
    jpb = jd.train(epochs=5, callbacks=False)
    td = _port_driver(poiseuille_no_bcs, arrays, tmp_path, opts=opts,
                      adam_epochs=10, second_round="jax")
    names = [l.name for l in td.losses]
    assert names == list(jpb.history.losses)
    assert not any(n.endswith("_x0") for n in names)
    tpb = td.train(epochs=5, callbacks=False)
    hj, ht = jpb.history, tpb.history
    assert ht.round_names == hj.round_names == ["keras_Adam", "jax_L-BFGS"]
    assert _theta0_dev(hj, ht) < THETA0_BAR
    assert pc._rel_devs(hj, ht, {1}) < ADAM_BAR
    assert pc._rel_devs(hj, ht, {2}) < ROUND_BAR


# ---------------------------------------------------------------------------
# the hand-rolled scripts
# ---------------------------------------------------------------------------

def _params(jm):
    return [{k: np.asarray(p[k]) for k in ("kernel", "bias")}
            for p in jm.params]


def _pressmean_draws():
    ks = jax.random.split(jax.random.PRNGKey(1), 10)
    jm = JaxMLP(2, 3, width=32, depth=3, seed=1,
                input_extents=[(-1.0, 1.0), (-1.0, 1.0)])
    box = lambda k, n, lo, hi: np.asarray(jax_box(ks[k], n, lo, hi))
    arrays = {
        "x_PDE": box(0, 1000, [-1, -1], [1, 1]),
        "x_BCD": np.concatenate([
            box(1, 100, [-1, -1], [-1, 1]), box(2, 100, [1, -1], [1, 1]),
            box(3, 100, [-1, -1], [1, -1]), box(4, 100, [-1, 1], [1, 1])]),
        "x_col": box(5, 5, [-1, -1], [1, 1]),
        "x_pres": box(6, 50, [-1, -1], [1, 1]),
        "noise_x": np.asarray(jax_noise(ks[7], 400, 0.0)),
        "noise_y": np.asarray(jax_noise(ks[8], 400, 0.0)),
        "x_test": box(9, 2000, [-1, -1], [1, 1]),
    }
    return arrays, _params(jm)


def _no_pressure_draws():
    ks = jax.random.split(jax.random.PRNGKey(2), 10)
    jm = JaxMLP(2, 2, width=32, depth=3, seed=2,
                input_extents=[(0.0, 1.0), (0.0, 0.1)])
    box = lambda k, n, lo, hi: np.asarray(jax_box(ks[k], n, lo, hi))
    arrays = {
        "x_PDE": box(0, 800, [0, 0], [1, 0.1]),
        "walls": np.concatenate([box(1, 50, [0, 0], [1, 0]),
                                 box(2, 50, [0, 0.1], [1, 0.1])]),
        "inflow": box(3, 50, [0, 0], [0, 0.1]),
        "x_test": box(4, 1000, [0, 0], [1, 0.1]),
    }
    return arrays, _params(jm)


def _adimensional_draws():
    L, H = poiseuille_adimensional.L, poiseuille_adimensional.H
    ks = jax.random.split(jax.random.PRNGKey(1), 10)
    jm = JaxMLP(2, 3, width=20, depth=3, seed=1,
                input_extents=[(0.0, L), (0.0, H)])
    box = lambda k, n, lo, hi: np.asarray(jax_box(ks[k], n, lo, hi))
    arrays = {
        "x_PDE": box(0, 200, [0, 0], [L, H]),
        "x_hint": box(1, 10, [0, 0], [L, H]),
        "x_BC_x0": box(2, 20, [0, 0], [0, H]),
        "x_BC_x1": box(3, 20, [L, 0], [L, H]),
        "x_BC_y0": box(4, 20, [0, 0], [L, 0]),
        "x_BC_y1": box(5, 20, [0, H], [L, H]),
        "x_test": box(6, 1000, [0, 0], [L, H]),
    }
    return arrays, _params(jm)


SCRIPTS = {
    "colliding_flow_pressmean": (
        "Colliding_Flow", colliding_flow_pressmean, _pressmean_draws,
        lambda mod, it, out: mod.main(it, out_dir=out, second_round="jax")),
    "poiseuille_no_pressure": (
        "Poiseuille_Flow", poiseuille_no_pressure, _no_pressure_draws,
        lambda mod, it, out: mod.main(it, out_dir=out, second_round="jax")),
    "poiseuille_adimensional": (
        "Poiseuille_Flow", poiseuille_adimensional, _adimensional_draws,
        lambda mod, it, out: mod.main(it, save_plots=False, out_dir=out,
                                      second_round="jax")),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_matches_tpinn(name, tmp_path):
    folder, case, draws, run_jax = SCRIPTS[name]
    iters = 5
    jpb, _ = run_jax(_example(folder, name), iters, str(tmp_path))
    arrays, params = draws()
    tpb, _ = case.from_arrays(arrays, params, device="cpu")
    assert [l.name for l in tpb.losses] == list(jpb.history.losses)
    assert [l.name for l in tpb.losses_test] == list(jpb.history.losses_test)
    for lj, lt in zip(jpb.losses, tpb.losses):
        assert (lt.weight, lt.normalization, lt.non_negative) == (
            lj.weight, lj.normalization, lj.non_negative)
    case.train(tpb, iters, "jax")
    hj, ht = jpb.history, tpb.history
    assert ht.round_names == hj.round_names == ["keras_Adam", "jax_L-BFGS"]
    assert ht.iters == hj.iters
    assert _theta0_dev(hj, ht) < THETA0_BAR
    assert pc._rel_devs(hj, ht, {1}) < ADAM_BAR
    assert pc._rel_devs(hj, ht, {2}) < ROUND_BAR


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_main_runs_from_a_seed(name, tmp_path):
    """Each script's main on the port's own draws: the history file, a
    falling loss, and the same run again from the same seed."""
    case = SCRIPTS[name][1]
    files = {"colliding_flow_pressmean": "Colliding_pressmean_history.json",
             "poiseuille_no_pressure": "Poiseuille_no_pressure_history.json",
             "poiseuille_adimensional": "Poiseuille_adim_history_loss.json"}
    pb, _ = case.main(2, out_dir=str(tmp_path / "a"), second_round="jax",
                      device="cpu")
    assert os.listdir(tmp_path / "a" / "Images") == [files[name]]
    h = pb.history
    assert h.round_names == ["keras_Adam", "jax_L-BFGS"]
    assert all(np.isfinite(h.loss_global))
    assert h.loss_global[-1] < h.loss_global[0]
    pb2, _ = case.main(2, out_dir=str(tmp_path / "b"), second_round="jax",
                       device="cpu")
    assert pb2.history.loss_global == h.loss_global
    with pytest.raises(ValueError, match="out_dir"):
        case.main(2, device="cpu")
