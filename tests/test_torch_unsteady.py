"""The port's unsteady space-time path against the JAX package's.

* the geometry of the space-time grid, the time-extruded boundary samples
  and the t = 0 samples against tpinn's (bit for bit where no random draw
  enters, by range and seed otherwise);
* ``initial_condition_residual`` against tpinn's on the same net and points;
* the unsteady ``StandardNSDriver`` against tpinn's: tpinn's driver on a
  small decaying-vortex case (a 3-8-8-3 net, 10 time slices of an 11 × 11
  grid) hands its grid, splits, boundary and t = 0 points, noisy targets,
  exact fields and initial θ to the port's ``from_arrays``; the Adam round's
  logs agree within 1e-10 and the dense BFGS round's, over 20 iterations,
  within 1e-8 (the bars of the steady slices, PERF.md section 2).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn import geometry as jg
from tpinn import pipeline as jpipe
from tpinn.models import MLP as JaxMLP
from tpinn_torch import geometry as tg
from tpinn_torch import pipeline as tpipe
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import CaseSpec, StandardNSDriver
from tpinn_torch.history import History
from tpinn_torch.losses import PrecomputedMeanSquares
from tpinn_torch.models import MLP
from tpinn_torch.pipeline import NSPhysics

torch.set_num_threads(1)

ADAM_BAR = 1e-10
BFGS_BAR = 1e-8
ITERS = 20
T, DT = 1e-2, 1e-3
OPTS = dict(epochs=ITERS, noise_fit=0.05, noise_bnd=0.05, n_pde=200, n_bc=20,
            n_ic=20, n_vel=10, n_pres=0, n_test=50)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nt,nx,ny", [(100, 11, 11), (3, 5, 7), (1, 4, 2)])
def test_space_time_grid_matches_tpinn(nt, nx, ny):
    t = np.arange(0.0, nt * 1e-4, step=1e-4)[:nt]
    x, y = np.linspace(0.0, 1.0, nx), np.linspace(-1.0, 2.0, ny)
    ref = np.asarray(jg.space_time_grid(t, x, y))
    got = tg.space_time_grid(torch.as_tensor(t), torch.as_tensor(x),
                             torch.as_tensor(y)).numpy()
    np.testing.assert_array_equal(got, ref)
    # t slowest, then y, then x
    np.testing.assert_array_equal(got[1], [t[0], x[1], y[0]])
    np.testing.assert_array_equal(got[nx], [t[0], x[0], y[1]])


def test_time_slices_line_up_with_the_data():
    """numpy's arange gives round(T/dt) slices, as the reference's grid."""
    for T_, dt in ((1e-2, 1e-4), (1e-2, 1e-3), (1.0, 0.1)):
        assert len(np.arange(0.0, T_, step=dt)) == int(round(T_ / dt))


@pytest.mark.parametrize("lo,hi,n", [(0.0, 1.0, 101), (-1.0, 1.0, 11),
                                     (0.0, 0.1, 26)])
def test_linspace_or_random_uniform_matches_tpinn(lo, hi, n):
    ref = np.asarray(jg.linspace_or_random(None, lo, hi, n, True))
    got = tg.linspace_or_random(None, lo, hi, n, True,
                                dtype=torch.float64).numpy()
    # within one ulp of the larger end (jnp.linspace's middle node of
    # (-1, 1) is 2.8e-17 where numpy's is 0)
    np.testing.assert_allclose(got, ref, rtol=0.0,
                               atol=np.spacing(max(abs(lo), abs(hi))))


def test_random_grid_by_range_and_seed():
    ext, shape = [(0.0, 2.0), (-1.0, 1.0)], (6, 4)
    ref = np.asarray(jg.rect_grid(ext, shape, uniform=False))
    a = tg.rect_grid(ext, shape, torch.float64, uniform=False,
                     generator=torch.Generator().manual_seed(3))
    b = tg.rect_grid(ext, shape, torch.float64, uniform=False,
                     generator=torch.Generator().manual_seed(3))
    assert a.shape == ref.shape == (35, 2)
    assert torch.equal(a, b)
    assert not torch.equal(a, tg.rect_grid(ext, shape, torch.float64))
    for col, (lo, hi) in enumerate(ext):
        assert lo <= float(a[:, col].min()) and float(a[:, col].max()) <= hi
    # x fastest: the first n1 + 1 rows share one y node
    assert torch.unique(a[:7, 1]).numel() == 1


def test_boundary_and_initial_points_like_tpinn():
    import jax

    ext = [(0.0, 1.0), (0.0, 2.0)]
    ref = jg.rect_boundary_points(jax.random.PRNGKey(0), ext, 50,
                                  time_horizon=T)
    got = tg.rect_boundary_points(torch.Generator().manual_seed(0), ext, 50,
                                  time_horizon=T, dtype=torch.float64)
    fixed = {"BOT": (2, 0.0), "DX": (1, 1.0), "TOP": (2, 2.0), "SX": (1, 0.0)}
    for edge, (col, value) in fixed.items():
        r, g = np.asarray(ref[edge]), got[edge].numpy()
        assert g.shape == r.shape == (50, 3)
        assert (g[:, col] == value).all() and (r[:, col] == value).all()
        assert 0.0 <= g[:, 0].min() and g[:, 0].max() < T
        free = 3 - col
        lo, hi = ext[free - 1]
        assert lo <= g[:, free].min() and g[:, free].max() <= hi
    ic = tg.initial_condition_points(torch.Generator().manual_seed(0), ext,
                                     40, torch.float64).numpy()
    ic_ref = np.asarray(jg.initial_condition_points(jax.random.PRNGKey(0),
                                                    ext, 40))
    assert ic.shape == ic_ref.shape == (40, 3)
    assert (ic[:, 0] == 0.0).all() and (ic_ref[:, 0] == 0.0).all()
    assert 0.0 <= ic[:, 2].min() and ic[:, 2].max() <= 2.0


# ---------------------------------------------------------------------------
# initial-condition residual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comp,rhs", [(0, 0.0), (1, 0.0), (2, 0.25)])
def test_initial_condition_residual_matches_tpinn(comp, rhs):
    jm = JaxMLP(3, 3, width=8, depth=2, seed=1)
    params = [{k: np.asarray(p[k]) for k in ("kernel", "bias")}
              for p in jm.params]
    tm = MLP(3, 3, width=8, depth=2, dtype=torch.float64, device="cpu")
    tm.set_params([{k: torch.as_tensor(p[k]) for k in p} for p in params])
    pts = np.random.default_rng(0).uniform(0.0, 1.0, (30, 3))
    pts[:, 0] = 0.0
    ref = np.asarray(jpipe.initial_condition_residual(jm, jnp.asarray(pts),
                                                      comp, rhs))
    got = tpipe.initial_condition_residual(tm, torch.as_tensor(pts), comp,
                                           rhs).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)


# ---------------------------------------------------------------------------
# the driver against tpinn's
# ---------------------------------------------------------------------------

def _vortex(xp):
    """A decaying vortex (u, v, p)(t, x, y) in the array module ``xp``."""
    decay = lambda q, k: xp.exp(-k * np.pi ** 2 * q[:, 0])
    u = lambda q: -xp.cos(np.pi * q[:, 1]) * xp.sin(np.pi * q[:, 2]) * decay(q, 2)
    v = lambda q: xp.sin(np.pi * q[:, 1]) * xp.cos(np.pi * q[:, 2]) * decay(q, 2)
    p = lambda q: -0.25 * (xp.cos(2 * np.pi * q[:, 1])
                           + xp.cos(2 * np.pi * q[:, 2])) * decay(q, 4)
    return u, v, p


def _spec(cls, exact_data=None):
    u, v, p = _vortex(torch if cls is CaseSpec else jnp)
    return cls(
        name="Vortex_Unsteady", extents=[(0.0, 1.0), (0.0, 1.0)],
        grid_shape=(10, 10), physics=(jpipe.NSPhysics if cls is not CaseSpec
                                      else NSPhysics)(conv=1.0, visc=1.0,
                                                      time=1.0),
        exact=None if exact_data is not None else (u, v, p),
        exact_data=exact_data,
        bnd_val={0: {e: u for e in ("BOT", "DX", "TOP", "SX")},
                 1: {e: v for e in ("BOT", "DX", "TOP", "SX")}},
        weights={"PDE_MASS": 1e1}, unsteady=True, time_horizon=T, dt=DT,
        width=8, depth=2)


def _jax_driver(tmp, **kw):
    from tpinn.config import SimulationOptions as JaxOptions
    from tpinn.driver import CaseSpec as JaxSpec
    from tpinn.driver import StandardNSDriver as JaxDriver

    return JaxDriver(_spec(JaxSpec), JaxOptions(**OPTS), base_dir=str(tmp),
                     save_results=False, seed=0, **kw)


def _arrays(jd):
    return dict(
        dom_grid=np.asarray(jd.dom_grid), idx_set=jd.idx_set,
        bnd_pts={k: np.asarray(v) for k, v in jd.bnd_pts.items()},
        bnd_val_num={c: {e: np.asarray(v) for e, v in d.items()}
                     for c, d in jd.bnd_val_num.items()},
        sol_noise=[np.asarray(a) for a in jd.sol_noise],
        ic_pts=np.asarray(jd.ic_pts),
        params=[{k: np.asarray(p[k]) for k in ("kernel", "bias")}
                for p in jd.model.params])


def _port_driver(jd, tmp, **kw):
    exact = tuple(np.asarray(f) for f in jd.exact_fields)
    return StandardNSDriver.from_arrays(
        _spec(CaseSpec, exact_data=exact), SimulationOptions(**OPTS),
        base_dir=str(tmp), save_results=False, seed=0, device="cpu",
        **_arrays(jd), **kw)


def _max_rel_dev(h_ref, h, upto=None):
    sel = slice(None) if upto is None else slice(0, upto)
    devs = [np.max(np.abs(np.array(h.loss_global)[sel]
                          - np.array(h_ref.loss_global)[sel])
                   / np.abs(np.array(h_ref.loss_global)[sel]))]
    for group in ("losses", "losses_test"):
        ref, got = getattr(h_ref, group), getattr(h, group)
        assert list(got) == list(ref)
        for name in ref:
            a = np.array(ref[name]["log"])[sel]
            b = np.array(got[name]["log"])[sel]
            devs.append(np.max(np.abs(b - a) / np.abs(a)))
    return float(max(devs))


def test_unsteady_driver_builds_like_tpinn(tmp_path):
    jd = _jax_driver(tmp_path, second_round="none", adam_epochs=0)
    td = _port_driver(jd, tmp_path, second_round="none", adam_epochs=0)
    assert td.dom_grid.shape == (10 * 121, 3)
    assert [l.name for l in td.losses] == [l.name for l in jd.losses]
    assert [l.name for l in td.losses][-5:] == ["IC_u", "IC_v", "IC_p",
                                                "Fit_u", "Fit_v"]
    assert [l.weight for l in td.losses] == [l.weight for l in jd.losses]
    assert (td.norm.norm_vel, td.norm.norm_pre) == (jd.norm.norm_vel,
                                                    jd.norm.norm_pre)
    # the PDE losses take the fused objective (kernels 1/2 on a CUDA batch,
    # their plain twin here), also at the case's 3-32-32-32-3
    assert all(isinstance(l, PrecomputedMeanSquares) for l in td.losses[:3])
    assert tpipe.use_fused_pde_losses(
        MLP(3, 3, width=32, depth=3, dtype=torch.float64, device="cpu"),
        True, 3)
    # the port's own draws: the grid equals tpinn's; the layer-0 extents
    # put (0, T) first
    own = StandardNSDriver(_spec(CaseSpec), SimulationOptions(**OPTS),
                           base_dir=str(tmp_path), save_results=False,
                           device="cpu", second_round="none")
    np.testing.assert_array_equal(own.dom_grid.numpy(), np.asarray(jd.dom_grid))
    assert own.model.input_extents == ((0.0, T), (0.0, 1.0), (0.0, 1.0))
    assert own.ic_pts.shape == (20, 3) and bool((own.ic_pts[:, 0] == 0).all())
    assert float(own.bnd_pts["TOP"][:, 0].max()) < T
    # the final slice of predict_grid
    gx, gy, u, v, p = own.predict_grid(n=5)
    assert u.shape == (5, 5) and np.isfinite(p).all()


def test_unsteady_adam_round_matches_tpinn(tmp_path):
    epochs = 20
    jd = _jax_driver(tmp_path, second_round="none", adam_epochs=epochs)
    td = _port_driver(jd, tmp_path, second_round="none", adam_epochs=epochs)
    jpb = jd.train(callbacks=False)
    tpb = td.train(callbacks=False)
    assert tpb.history.iters == jpb.history.iters == [0, 10, 20]
    assert _max_rel_dev(jpb.history, tpb.history) < ADAM_BAR


def _wrapped_plain(jd):
    """tpinn's problem with the PDE losses as scalar losses, so that its
    BFGS round takes the plain variant, as the port's fused objective
    does."""
    import tpinn as jns

    losses = [jns.Loss(l.name, l.raw_value, weight=l.weight)
              if l.name.startswith("PDE") else l for l in jd.losses]
    return jns.OptimizationProblem(jd.model.variables, losses,
                                   jd.losses_test, callbacks=[])


@pytest.mark.parametrize("kind", ["bfgs_plain", "bfgs_paired"])
def test_unsteady_bfgs_round_matches_tpinn(tmp_path, kind):
    """Adam 10 epochs, then the dense BFGS round for 20 iterations: the
    plain variant (the port's fused objective against tpinn's PDE losses
    as scalars) and the paired one (TPINN_USE_PALLAS=0, every loss a
    residual vector, in both)."""
    import tpinn as jns

    jd = _jax_driver(tmp_path, second_round="jax-bfgs", adam_epochs=10)
    if kind == "bfgs_plain":
        td = _port_driver(jd, tmp_path, second_round="jax-bfgs",
                          adam_epochs=10)
        ref = _wrapped_plain(jd)
        jns.minimize(ref, "keras", jns.optimizers.Adam(learning_rate=1e-2),
                     num_epochs=10)
        jns.minimize(ref, "jax", "BFGS", num_epochs=ITERS)
        tpb = td.train(epochs=ITERS, callbacks=False)
    else:
        os.environ["TPINN_USE_PALLAS"] = "0"
        try:
            td = _port_driver(jd, tmp_path, second_round="jax-bfgs",
                              adam_epochs=10)
            tpb = td.train(epochs=ITERS, callbacks=False)
        finally:
            os.environ.pop("TPINN_USE_PALLAS", None)
        ref = jd.train(epochs=ITERS, callbacks=False)
    h, hj = tpb.history, ref.history
    assert str(ref.last_opt_state["kind"]) == tpb.last_opt_state["kind"] == kind
    assert h.round_names == hj.round_names == ["keras_Adam", "jax_BFGS"]
    assert h.iters == hj.iters
    assert _max_rel_dev(hj, h) < BFGS_BAR
    assert h.loss_global[-1] < h.loss_global[0]


def test_unsteady_artifacts_and_time_slices(tmp_path):
    """The run folder of an unsteady run with exact_data: the experiment
    files and the five per-slice figures (Graphic.jpg needs the exact
    callables, as in tpinn); a mismatched exact_data raises."""
    jd = _jax_driver(tmp_path, second_round="none", adam_epochs=0)
    exact = tuple(np.asarray(f) for f in jd.exact_fields)
    drv = StandardNSDriver(_spec(CaseSpec, exact_data=exact),
                           SimulationOptions(**OPTS), base_dir=str(tmp_path),
                           device="cpu", second_round="none", adam_epochs=3)
    drv.train()
    drv.save_artifacts(loss_groups={"Initial_Conditions": ["IC_u", "IC_v",
                                                           "IC_p"]})
    files = set(os.listdir(drv.folder))
    assert {"Model.json", "History_Loss.json", "checkpoint.pkl",
            "Test_Options.txt", "Loss_Trend_Reduced.png"} <= files
    assert "Graphic.jpg" not in files
    assert {f"Graphic_{i}_of_5.jpg" for i in range(1, 6)} <= files
    assert History.load(os.path.join(drv.folder, "History_Loss.json")).iters \
        == [0, 3]
    with pytest.raises(ValueError, match="exact_data"):
        StandardNSDriver(_spec(CaseSpec, exact_data=tuple(e[:-1] for e in exact)),
                         SimulationOptions(**OPTS), base_dir=str(tmp_path),
                         device="cpu")
