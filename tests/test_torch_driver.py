"""The port's Poiseuille driver against the JAX package's.

The slice parity test builds tpinn's StandardNSDriver on the Poiseuille case
in float64, carries its grid, splits, boundary data, fit targets and initial
θ into tpinn_torch's driver (from_arrays), runs the same 20-epoch Adam round
in both, and compares the two History logs by their largest relative
deviation.  Bar: 1e-10 (PERF.md explains it: the measured deviation is
3e-15 at 20 epochs and 7.5e-15 at 100).
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.history import History as JaxHistory
from tpinn_torch.cases import poiseuille_flow as pf_torch
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import StandardNSDriver
from tpinn_torch.history import History
from tpinn_torch.losses import LossMeanSquares, PrecomputedMeanSquares
from tpinn_torch.models import MLP
from tpinn_torch.optimize import _log_iters, minimize
from tpinn_torch.problem import OptimizationProblem
from tpinn_torch.optimizers import SGD, Adam, AdamW

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HISTORY_BAR = 1e-10


def _jax_example():
    path = os.path.join(_REPO, "examples", "Poiseuille_Flow",
                        "poiseuille_flow.py")
    spec = importlib.util.spec_from_file_location("poiseuille_flow_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def test_poiseuille_history_matches_tpinn(tmp_path):
    from tpinn.driver import StandardNSDriver as JaxDriver

    jex = _jax_example()
    epochs = 20
    jd = JaxDriver(jex.build_spec(), jex.default_options(),
                   base_dir=str(tmp_path), save_results=False, seed=0,
                   second_round="none", adam_epochs=epochs)
    arrays = dict(
        dom_grid=np.asarray(jd.dom_grid), idx_set=jd.idx_set,
        bnd_pts={k: np.asarray(v) for k, v in jd.bnd_pts.items()},
        bnd_val_num={c: {e: np.asarray(v) for e, v in d.items()}
                     for c, d in jd.bnd_val_num.items()},
        sol_noise=[np.asarray(a) for a in jd.sol_noise],
        params=[{k: np.asarray(p[k]) for k in ("kernel", "bias")}
                for p in jd.model.params])
    jpb = jd.train(callbacks=False)

    td = StandardNSDriver.from_arrays(
        pf_torch.build_spec(), pf_torch.default_options(),
        base_dir=str(tmp_path), save_results=False, seed=0,
        adam_epochs=epochs, device="cpu", second_round="none", **arrays)
    assert (td.norm.norm_vel, td.norm.norm_pre) == (jd.norm.norm_vel,
                                                    jd.norm.norm_pre)
    # the port's CPU driver takes the fused objective's plain twin
    assert all(isinstance(l, PrecomputedMeanSquares) for l in td.losses[:3])
    tpb = td.train()
    assert tpb.history.iters == jpb.history.iters == [0, 10, 20]
    assert tpb.history.round_names == jpb.history.round_names == ["keras_Adam"]
    assert _max_rel_dev(jpb.history, tpb.history) < HISTORY_BAR
    for name, entry in jpb.history.losses.items():
        assert tpb.history.losses[name]["weight"] == entry["weight"]


def test_poiseuille_main_writes_history(tmp_path):
    drv = pf_torch.main(str(tmp_path), adam_epochs=12, device="cpu",
                        second_round="none")
    folder = drv.folder
    assert os.path.basename(folder) == "Test_Case_#001"
    path = os.path.join(folder, "History_Loss.json")
    h = History.load(path)
    assert h.iters == [0, 10, 12]
    assert h.loss_global[-1] < h.loss_global[0]
    assert all(np.isfinite(h.loss_global))
    # the file keeps the JAX package's schema: tpinn loads it too
    hj = JaxHistory.load(path)
    assert hj.loss_global == h.loss_global and list(hj.losses) == list(h.losses)
    with open(path) as f:
        d = json.load(f)
    assert set(d) == {"log", "losses", "losses_test", "log_rounds"}
    assert set(drv.final_test_losses()) == {"u_test", "v_test", "p_test"}
    # loss_global is the weighted sum of the logged raw values
    total = sum(e["weight"] * e["log"][-1] for e in h.losses.values())
    np.testing.assert_allclose(h.loss_global[-1], total, rtol=1e-14)


def test_driver_from_seed_is_reproducible(tmp_path):
    opts = SimulationOptions(epochs=0, n_pde=40, n_bc=8, n_vel=4, n_test=20)
    spec = pf_torch.build_spec()
    spec.grid_shape = (10, 5)
    a = StandardNSDriver(spec, opts, base_dir=str(tmp_path), device="cpu",
                         save_results=False, adam_epochs=3,
                         second_round="none")
    b = StandardNSDriver(spec, opts, base_dir=str(tmp_path), device="cpu",
                         save_results=False, adam_epochs=3,
                         second_round="none")
    assert all(np.array_equal(a.idx_set[k], b.idx_set[k]) for k in a.idx_set)
    assert all(torch.equal(p, q) for p, q in zip(a.model.flat_params(),
                                                 b.model.flat_params()))
    assert [l.name for l in a.losses] == [
        "PDE_MASS", "PDE_MOMU", "PDE_MOMV", "BCD_u_y0", "BCD_u_y1",
        "BCD_u_x0", "BCN_u_x1", "BCD_v_y0", "BCD_v_y1", "BCD_v_x0",
        "BCN_v_x1", "Fit_u", "Fit_v"]
    assert a.train().history.loss_global == b.train().history.loss_global


def test_driver_refuses_unported_options(tmp_path, monkeypatch):
    spec, opts = pf_torch.build_spec(), pf_torch.default_options()
    spec.unsteady = True
    with pytest.raises(NotImplementedError, match="unsteady.*item 6"):
        StandardNSDriver(spec, opts, base_dir=str(tmp_path), device="cpu",
                         second_round="jax")
    spec = pf_torch.build_spec()
    spec.pressure_gauge = "median"
    with pytest.raises(ValueError, match="pressure_gauge"):
        StandardNSDriver(spec, opts, base_dir=str(tmp_path), device="cpu")
    spec = pf_torch.build_spec()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StandardNSDriver(spec, opts, base_dir=str(tmp_path))


def test_minimize_strategies():
    assert _log_iters(25, 10) == [0, 10, 20, 25]
    assert _log_iters(20, 10) == [0, 10, 20]
    # the float32 split carry of the dense BFGS round still raises
    model = MLP(2, 1, width=4, depth=1, dtype=torch.float32, device="cpu")
    x = torch.rand(8, 2)
    pb = OptimizationProblem(model, [LossMeanSquares(
        "fit", lambda: model(x)[:, 0] - 1.0)])
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 14"):
        minimize(pb, "jax", "BFGS")
    with pytest.raises(ValueError, match="unknown strategy"):
        minimize(None, "newton")


def test_adam_matches_optax():
    """Adam in optax's operation order: the same trajectory to the last
    bits on a quadratic in float64."""
    import jax
    import optax

    rng = np.random.default_rng(0)
    A = rng.normal(size=(6, 6))
    A = A @ A.T + np.eye(6)
    b = rng.normal(size=6)
    x0 = rng.normal(size=6)
    opt = optax.adam(1e-2)
    xj, st = jnp.asarray(x0), None
    st = opt.init(xj)
    grad = jax.jit(jax.grad(lambda x: 0.5 * x @ (jnp.asarray(A) @ x)
                            - jnp.asarray(b) @ x))
    xt = torch.tensor(x0, requires_grad=True)
    adam = Adam(1e-2)
    adam.init([xt])
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for _ in range(50):
        u, st = opt.update(grad(xj), st, xj)
        xj = optax.apply_updates(xj, u)
        g = At @ xt.detach() - bt
        adam.step([xt], [g])
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj),
                               rtol=1e-13, atol=1e-15)


def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(6, 6))
    A = A @ A.T + np.eye(6)
    return A, rng.normal(size=6), rng.normal(size=6)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.1, "b1": 0.8}),
])
def test_sgd_and_adamw_match_optax(name, kw):
    """SGD and AdamW in optax's operation order, as tpinn's shims build
    them (optax.sgd / optax.adamw with the same keyword arguments): the
    same trajectory to the last bits on a quadratic in float64."""
    import jax
    import optax

    A, b, x0 = _quadratic(1)
    lr = 1e-2
    opt = {"sgd": optax.sgd, "adamw": optax.adamw}[name](lr, **kw)
    ours = {"sgd": SGD, "adamw": AdamW}[name](lr, **kw)
    assert ours.name == {"sgd": "SGD", "adamw": "AdamW"}[name]
    xj = jnp.asarray(x0)
    st = opt.init(xj)
    grad = jax.jit(jax.grad(lambda x: 0.5 * x @ (jnp.asarray(A) @ x)
                            - jnp.asarray(b) @ x))
    xt = torch.tensor(x0)
    ours.init([xt])
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for _ in range(50):
        u, st = opt.update(grad(xj), st, xj)
        xj = optax.apply_updates(xj, u)
        ours.step([xt], [At @ xt - bt])
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-13,
                               atol=1e-15)


@pytest.mark.parametrize("opt,name", [(1e-3, "keras_Adam"),
                                      (SGD(1e-3), "keras_SGD"),
                                      (AdamW(1e-3), "keras_AdamW"),
                                      (None, "keras_Adam")])
def test_minimize_keras_takes_a_rate_or_any_ported_optimizer(tmp_path, opt,
                                                             name):
    """minimize(pb, "keras", ...) takes what tpinn's takes: a learning rate
    (Adam), SGD, AdamW or nothing (Adam(1e-2)); the round is named after
    the optimizer.  A number gives the same round as Adam at that rate."""
    opts = SimulationOptions(epochs=0, n_pde=20, n_bc=6, n_vel=4, n_test=10)
    spec = pf_torch.build_spec()
    spec.grid_shape = (10, 5)

    def run(optimizer):
        d = StandardNSDriver(spec, opts, base_dir=str(tmp_path),
                             device="cpu", save_results=False,
                             second_round="none")
        pb = OptimizationProblem(d.model, d.losses, d.losses_test)
        minimize(pb, "keras", optimizer, num_epochs=3)
        return pb.history

    h = run(opt)
    assert h.round_names == [name] and h.iters == [0, 3]
    assert h.loss_global[-1] != h.loss_global[0]
    if opt == 1e-3:
        assert h.loss_global == run(Adam(1e-3)).loss_global


def test_minimize_keras_refuses_an_optax_transform():
    import optax

    with pytest.raises(TypeError, match="JAX package"):
        minimize(None, "keras", optax.adam(1e-3))
