"""The NS-residual functions of tpinn_torch.kernels.mlp_bundle.

The plain versions (what the CPU runs, and what the CUDA kernels are held
to on the card) against two references of the JAX package:

* the closed-form residual path under ``jax.grad``, as tests/test_pallas.py
  holds the Pallas kernels to it: loss and MSEs at rtol 1e-12, parameter
  gradients at rtol 1e-9 / atol 1e-12;
* once, small, the Pallas one-pass kernel itself in interpret mode
  (``tpinn.pallas.ns_residual_weighted_obj(..., interpret=True)``) with a
  masked tail (n_valid < n).

The autograd.Function contracts (gradient = g · dparams, MSEs carry no
gradient) are checked on the CPU with the kernel wrapper replaced by its
plain computation; the kernels themselves are compared on the card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.geometry import Normalization as JaxNorm
from tpinn.models import MLP as JaxMLP
from tpinn.pipeline import NSPhysics as JaxPhysics
from tpinn.pipeline import ResidualBundle as JaxBundle
from tpinn.pipeline import mass_residual as jax_mass
from tpinn.pipeline import momentum_residual as jax_mom
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.geometry import Normalization
from tpinn_torch.kernels import mlp_bundle as mb
from tpinn_torch.models import MLP
from tpinn_torch.pipeline import FusedNSWeightedObjective, NSPhysics

torch.set_num_threads(1)

W3 = (10.0, 1.0, 1.0)


def _ravel(params):
    """JAX params flattened in the port's order: kernel, bias per layer."""
    return np.concatenate([np.asarray(p[k]).reshape(-1) for p in params
                           for k in ("kernel", "bias")])


LAYOUTS = {
    # d_in, physics coefficients, normalization data
    "steady": (2, dict(conv=3100.0, visc=890.0),
               ([0.0, 500.0], [0.0, 250.0], [-1e4, 1e4])),
    "unsteady": (3, dict(conv=1.0, visc=1.0, time=1.0),
                 ([0.0, 1.0], [0.0, 1.0], [-2.0, 2.0])),
}


def _case(layout, n, seed):
    d_in, coef, nd = LAYOUTS[layout]
    jm = JaxMLP(d_in, 3, width=32, depth=3, seed=seed, dtype=jnp.float64)
    pnp = [{k: np.asarray(p[k]) for k in ("kernel", "bias")} for p in jm.params]
    x = np.random.default_rng(seed).uniform(0, 1, (n, d_in))
    jnorm = JaxNorm(*(np.array(a) for a in nd))
    tnorm = Normalization(*(np.array(a) for a in nd))
    return jm, pnp, x, JaxPhysics(**coef), NSPhysics(**coef), jnorm, tnorm


def _jax_loss_and_grad(jm, x, phys, norm, unsteady, w=W3):
    xj = jnp.asarray(x)

    def mses(p):
        prev = jm._bound
        jm._bound = p
        b = JaxBundle(jm, xj, unsteady=unsteady, use_pallas=False)
        out = jnp.stack([jnp.mean(jax_mass(b, norm) ** 2),
                         jnp.mean(jax_mom(b, 0, phys, norm) ** 2),
                         jnp.mean(jax_mom(b, 1, phys, norm) ** 2)])
        jm._bound = prev
        return out

    loss = lambda p: jnp.dot(jnp.asarray(w), mses(p))
    g = _ravel(jax.grad(loss)(jm.params))
    return float(loss(jm.params)), np.asarray(mses(jm.params)), g


def _plain_loss_and_grad(pnp, x, phys, norm, n_valid=None, n_mean=None):
    params = params_from_numpy(pnp)
    flat = [t.requires_grad_(True) for p in params for t in (p["kernel"], p["bias"])]
    loss, mses = mb.ns_residual_weighted_obj_plain(
        params, torch.as_tensor(x), phys, norm, W3, n_valid, n_mean)
    grads = torch.autograd.grad(loss, flat)
    return (float(loss.detach()), mses.numpy(),
            torch.cat([g.reshape(-1) for g in grads]).numpy())


@pytest.mark.parametrize("layout", ["steady", "unsteady"])
def test_plain_weighted_obj_matches_jax_grad(layout):
    jm, pnp, x, jphys, tphys, jnorm, tnorm = _case(layout, 300, 2)
    l_ref, m_ref, g_ref = _jax_loss_and_grad(jm, x, jphys, jnorm,
                                             layout == "unsteady")
    l, m, g = _plain_loss_and_grad(pnp, x, tphys, tnorm)
    np.testing.assert_allclose(l, l_ref, rtol=1e-12)
    np.testing.assert_allclose(m, m_ref, rtol=1e-12)
    np.testing.assert_allclose(g, g_ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("layout", ["steady", "unsteady"])
def test_plain_masked_equals_truncated_batch(layout):
    """n_valid masks the tail; with n_mean = n_valid the result is the
    JAX reference on the first n_valid rows."""
    jm, pnp, x, jphys, tphys, jnorm, tnorm = _case(layout, 131, 4)
    m_valid = 97
    l_ref, m_ref, g_ref = _jax_loss_and_grad(jm, x[:m_valid], jphys, jnorm,
                                             layout == "unsteady")
    l, m, g = _plain_loss_and_grad(pnp, x, tphys, tnorm, m_valid, m_valid)
    np.testing.assert_allclose(l, l_ref, rtol=1e-12)
    np.testing.assert_allclose(m, m_ref, rtol=1e-12)
    np.testing.assert_allclose(g, g_ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("layout", ["steady", "unsteady"])
def test_plain_mse_gradient_matches_jax(layout):
    """ns_residual_mse_plain differentiates like the weighted objective."""
    jm, pnp, x, jphys, tphys, jnorm, tnorm = _case(layout, 200, 6)
    _, m_ref, g_ref = _jax_loss_and_grad(jm, x, jphys, jnorm,
                                         layout == "unsteady")
    params = params_from_numpy(pnp)
    flat = [t.requires_grad_(True) for p in params for t in (p["kernel"], p["bias"])]
    mses = mb.ns_residual_mse_plain(params, torch.as_tensor(x), tphys, tnorm)
    assert mses.requires_grad
    g = torch.autograd.grad((torch.tensor(W3, dtype=torch.float64) * mses).sum(), flat)
    np.testing.assert_allclose(mses.detach().numpy(), m_ref, rtol=1e-12)
    np.testing.assert_allclose(torch.cat([t.reshape(-1) for t in g]).numpy(),
                               g_ref, rtol=1e-9, atol=1e-12)


def test_plain_matches_pallas_one_pass_kernel_interpret():
    """Once, small: the Pallas one-pass kernel (interpret mode on the CPU)
    with a masked tail, n = 300, n_valid = 250."""
    from tpinn.pallas import ns_residual_weighted_obj as pallas_obj

    jm, pnp, x, jphys, tphys, jnorm, tnorm = _case("steady", 300, 8)
    n_valid = 250
    xj = jnp.asarray(x)
    obj = lambda p: pallas_obj(p, xj, jphys, jnorm, W3, np_tile=256,
                               interpret=True, n_valid=n_valid,
                               n_mean=n_valid)
    (l_ref, m_ref) = obj(jm.params)
    g_ref = _ravel(jax.grad(lambda p: obj(p)[0])(jm.params))
    l, m, g = _plain_loss_and_grad(pnp, x, tphys, tnorm, n_valid, n_valid)
    np.testing.assert_allclose(l, float(l_ref), rtol=1e-12)
    np.testing.assert_allclose(m, np.asarray(m_ref), rtol=1e-12)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# autograd.Function contracts, the kernel wrappers replaced by plain math
# ---------------------------------------------------------------------------


def _plain_bwd(params, x, physics, norm, gbar, n_valid=None, n_mean=None,
               with_loss=False):
    """What kernel 1 returns, computed with autograd on the CPU."""
    with torch.enable_grad():
        leaves = [{k: p[k].detach().clone().requires_grad_(True)
                   for k in ("kernel", "bias")} for p in params]
        mses = mb.ns_residual_mse_plain(leaves, x, physics, norm, n_valid, n_mean)
        loss = (gbar * mses).sum()
        flat = [t for p in leaves for t in (p["kernel"], p["bias"])]
        grads = torch.autograd.grad(loss, flat)
    dparams = [{"kernel": grads[i], "bias": grads[i + 1]}
               for i in range(0, len(grads), 2)]
    return dparams, mses.detach(), (loss.detach() if with_loss else None)


def _plain_fwd(params, x, physics, norm, n_valid=None, n_mean=None):
    with torch.no_grad():
        return mb.ns_residual_mse_plain(params, x, physics, norm, n_valid, n_mean)


@pytest.fixture
def fake_kernels(monkeypatch):
    calls = {"bwd": 0, "fwd": 0}

    def bwd(*a, **k):
        calls["bwd"] += 1
        return _plain_bwd(*a, **k)

    def fwd(*a, **k):
        calls["fwd"] += 1
        return _plain_fwd(*a, **k)

    monkeypatch.setattr(mb, "ns_residual_bwd", bwd)
    monkeypatch.setattr(mb, "ns_residual_fwd", fwd)
    return calls


def test_weighted_objective_function_contract(fake_kernels):
    _, pnp, x, _, tphys, _, tnorm = _case("steady", 64, 3)
    params = params_from_numpy(pnp)
    flat = [t.requires_grad_(True) for p in params for t in (p["kernel"], p["bias"])]
    spec = mb._Spec(tphys, tnorm, None, None,
                    torch.tensor(W3, dtype=torch.float64))
    loss, mses = mb._WeightedObjective.apply(torch.as_tensor(x), spec, *flat)
    assert fake_kernels["bwd"] == 1
    assert loss.requires_grad and not mses.requires_grad
    g = 2.5
    grads = torch.autograd.grad(g * loss, flat)
    dparams, mses_ref, loss_ref = _plain_bwd(params, torch.as_tensor(x), tphys,
                                             tnorm, spec.weights, with_loss=True)
    ref = [t for p in dparams for t in (p["kernel"], p["bias"])]
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), g * b.numpy(), rtol=1e-15)
    np.testing.assert_array_equal(mses.numpy(), mses_ref.numpy())
    np.testing.assert_array_equal(loss.detach().numpy(), loss_ref.numpy())


def test_residual_mse_function_contract(fake_kernels):
    _, pnp, x, _, tphys, _, tnorm = _case("unsteady", 64, 5)
    params = params_from_numpy(pnp)
    flat = [t.requires_grad_(True) for p in params for t in (p["kernel"], p["bias"])]
    spec = mb._Spec(tphys, tnorm, 50, 50)
    mses = mb._ResidualMSE.apply(torch.as_tensor(x), spec, *flat)
    assert fake_kernels == {"bwd": 0, "fwd": 1}
    gbar = torch.tensor([0.5, 2.0, -1.0], dtype=torch.float64)
    grads = torch.autograd.grad((gbar * mses).sum(), flat)
    assert fake_kernels == {"bwd": 1, "fwd": 1}
    ref = torch.autograd.grad(
        (gbar * mb.ns_residual_mse_plain(params, torch.as_tensor(x), tphys,
                                         tnorm, 50, 50)).sum(), flat)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-15)


# ---------------------------------------------------------------------------
# routing and argument checks
# ---------------------------------------------------------------------------


def test_cpu_tensor_takes_the_plain_version():
    _, pnp, x, _, tphys, _, tnorm = _case("steady", 40, 1)
    params = params_from_numpy(pnp)
    xt = torch.as_tensor(x)
    l1, m1 = mb.ns_residual_weighted_obj(params, xt, tphys, tnorm, W3)
    l2, m2 = mb.ns_residual_weighted_obj_plain(params, xt, tphys, tnorm, W3)
    assert torch.equal(l1, l2) and torch.equal(m1, m2)
    assert torch.equal(mb.ns_residual_mse(params, xt, tphys, tnorm),
                       mb.ns_residual_mse_plain(params, xt, tphys, tnorm))


def test_kernel_wrappers_refuse_cpu_and_other_devices():
    _, pnp, x, _, tphys, _, tnorm = _case("steady", 16, 1)
    params = params_from_numpy(pnp)
    xt = torch.as_tensor(x)
    gbar = torch.tensor(W3, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        mb.ns_residual_bwd(params, xt, tphys, tnorm, gbar)
    with pytest.raises(ValueError, match="CUDA"):
        mb.ns_residual_fwd(params, xt, tphys, tnorm)
    with pytest.raises(ValueError, match="no path"):
        mb.ns_residual_weighted_obj(params, xt.to("meta"), tphys, tnorm, W3)


def test_mismatched_layout_raises():
    _, pnp, x, _, _, _, tnorm = _case("steady", 16, 1)
    params = params_from_numpy(pnp)
    with pytest.raises(ValueError, match="expected 3"):
        mb.ns_residual_mse(params, torch.as_tensor(x), NSPhysics(time=1.0), tnorm)
    _, pnp3, x3, _, _, _, _ = _case("unsteady", 16, 1)
    with pytest.raises(ValueError, match="expected 2"):
        mb.ns_residual_mse(params_from_numpy(pnp3), torch.as_tensor(x3),
                           NSPhysics(), tnorm)


@pytest.mark.parametrize("widths,d_in,ok", [
    ((2, 32, 32, 32, 3), 2, True),
    ((3, 32, 32, 32, 3), 3, True),
    ((2, 64, 64, 3), 2, True),
    ((2, 128, 3), 2, False),        # wider than two neurons per lane
    ((2,) + (16,) * 8 + (3,), 2, False),  # more than MAX_LAYERS layers
    ((2, 32, 4), 2, False),         # not a (u, v, p) head
    ((3, 32, 3), 2, False),         # d_in disagrees with the layout
])
def test_fits_kernel(widths, d_in, ok):
    assert mb.fits_kernel(widths, d_in) is ok


def test_main_path_block_plan_fits_two_blocks_per_sm():
    """The main path's tile plan, through the Python mirror of the kernels'
    layout (``Layout::build`` and ``plan_points`` in csrc/taylor_mlp.cuh).
    2-32-32-32-3 pads the head to 8 and strides every stream matrix by
    width + 4; n = 1000 in float64 takes 8-point tiles (40 stream rows),
    whose backward block needs 137,856 bytes: one block of 512 threads per
    SM within the card's 227 KB (two no longer share an SM; the forward
    block is smaller).  At 1M points float64 takes 16 points, whose block
    fits only with the accumulators in the partials, and float32 takes 32."""
    w = (2, 32, 32, 32, 3)
    lay = mb.tile_layout(w, 2, 8, True)
    assert lay["wp"] == [2, 32, 32, 32, 8]
    assert lay["ld"] == [2, 36, 36, 36, 12]
    assert lay["R"] == 40 and lay["R"] == 8 * (1 + 2 + 2)
    assert lay["n_acc"] == sum((a + 1) * b for a, b in zip(w[:-1], w[1:])) + 3
    assert mb.plan_points(w, 2, 3, 0, 8, 1000) == 8
    assert 8 * lay["total"] == 137_856 <= mb.SMEM_LIMIT
    assert 8 * lay["total"] > 113 * 1024
    assert mb.smem_elems(w, 2, 8, False) < lay["total"]
    assert 8 * mb.smem_elems(w, 2, 16, True) > mb.SMEM_LIMIT
    assert 8 * mb.smem_elems(w, 2, 16, True, acc_smem=False) <= mb.SMEM_LIMIT
    assert mb.plan_points(w, 2, 3, 0, 8, 1 << 20) == 16
    assert mb.plan_points(w, 2, 3, 0, 4, 1 << 20) == 32
    # float64 DMMA fragments: lanes 0-15 read rows r < 4, columns k < 4 of
    # a stream matrix; a row stride of width + 4 puts them in 16 distinct
    # 8-byte banks
    for ld in lay["ld"][1:]:
        assert len({(r * ld + k) % 16 for r in range(4) for k in range(4)}) == 16


# ---------------------------------------------------------------------------
# the fused objective used by the driver
# ---------------------------------------------------------------------------


def _fused(weights=W3, n=48):
    model = MLP(2, 3, width=16, depth=2, seed=0, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (n, 2)))
    norm = Normalization(np.array([0.0, 2.0]), np.array([0.0, 1.0]),
                         np.array([0.0, 5.0]))
    phys = NSPhysics(conv=3.0, visc=0.5)
    return model, x, phys, norm, FusedNSWeightedObjective(model, x, phys, norm,
                                                          weights)


def test_fused_objective_values_and_gradient():
    model, x, phys, norm, fused = _fused()
    fns = fused.loss_fns()
    vals = [f() for f in fns]
    mses = mb.ns_residual_mse_plain(model.params, x, phys, norm).detach()
    for v, m in zip(vals, mses):
        assert float(v) == float(m)
    total = sum(w * v for w, v in zip(W3, vals))
    g = torch.autograd.grad(total, model.flat_params())
    loss, _ = mb.ns_residual_weighted_obj_plain(model.params, x, phys, norm, W3)
    ref = torch.autograd.grad(loss, model.flat_params())
    for a, b in zip(g, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-16)


def test_fused_objective_one_call_per_parameter_state(monkeypatch):
    """The three channels share one call; an in-place optimizer update
    (same tensors, new version) recomputes instead of returning the
    previous step's loss; no_grad evaluations take the forward function."""
    model, x, phys, norm, fused = _fused()
    calls = {"obj": 0, "mse": 0}
    real_obj, real_mse = mb.ns_residual_weighted_obj, mb.ns_residual_mse

    def obj(*a, **k):
        calls["obj"] += 1
        return real_obj(*a, **k)

    def mse(*a, **k):
        calls["mse"] += 1
        return real_mse(*a, **k)

    monkeypatch.setattr(mb, "ns_residual_weighted_obj", obj)
    monkeypatch.setattr(mb, "ns_residual_mse", mse)
    fns = fused.loss_fns()
    first = [float(f()) for f in fns]
    assert calls == {"obj": 1, "mse": 0}
    with torch.no_grad():
        for p in model.flat_params():
            p.add_(0.01)
    second = [float(f()) for f in fns]
    assert calls == {"obj": 2, "mse": 0}
    assert second != first
    ref = mb.ns_residual_mse_plain(model.params, x, phys, norm).tolist()
    assert second == ref
    with torch.no_grad():
        third = [float(f()) for f in fns]
    assert calls == {"obj": 2, "mse": 1} and third == ref


def test_fused_gradient_rides_first_nonzero_weight():
    w = (0.0, 2.0, 1.0)
    model, x, phys, norm, fused = _fused(weights=w)
    fns = fused.loss_fns()
    vals = [f() for f in fns]
    assert not vals[0].requires_grad and vals[1].requires_grad
    assert not vals[2].requires_grad
    total = sum(wi * v for wi, v in zip(w, vals))
    g = torch.autograd.grad(total, model.flat_params())
    loss, _ = mb.ns_residual_weighted_obj_plain(model.params, x, phys, norm, w)
    ref = torch.autograd.grad(loss, model.flat_params())
    for a, b in zip(g, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-16)
