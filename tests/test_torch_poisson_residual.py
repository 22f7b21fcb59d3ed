"""The Poisson-residual functions of tpinn_torch.kernels.mlp_bundle.

The plain versions (what the CPU runs, and what the CUDA kernels are held
to on the card) against two references of the JAX package, at the
examples' widths 2-20-20-20-1 in float64:

* the closed-form jet (``taylor_tri_fn``) under ``jax.grad``, as
  tests/test_pallas.py holds the Pallas kernels to it: loss and MSE at
  rtol 1e-12, parameter gradients at rtol 1e-9 / atol 1e-12;
* once, small, the Pallas one-pass kernel itself in interpret mode
  (``tpinn.pallas.poisson_residual_weighted_obj(..., interpret=True)``)
  with a masked tail.

The autograd.Function contracts are checked on the CPU with the kernel
wrappers replaced by their plain computation; the kernels themselves are
compared on the card by tests/test_torch_cuda.py and chip_smoke.py.  Also
here: the fit check of the Poisson head and the warning for nets that no
kernel takes.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.models import MLP as JaxMLP
from tpinn.pipeline import taylor_tri_fn
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.kernels import mlp_bundle as mb
from tpinn_torch.models import MLP
from tpinn_torch.pipeline import FusedPoissonObjective, use_fused_pde_losses

torch.set_num_threads(1)

W = 2 * np.pi
WEIGHT = 2.0


def _ravel(params):
    """JAX params flattened in the port's order: kernel, bias per layer."""
    return np.concatenate([np.asarray(p[k]).reshape(-1) for p in params
                           for k in ("kernel", "bias")])


def _case(n, seed, width=20, depth=3):
    jm = JaxMLP(2, 1, width=width, depth=depth, seed=seed, dtype=jnp.float64,
                input_extents=[(0.0, W), (0.0, W)])
    pnp = [{k: np.asarray(p[k]) for k in ("kernel", "bias")} for p in jm.params]
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, W, (n, 2))
    f = 2.0 * np.sin(x[:, 0]) * np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    return jm, pnp, x, f


def _jax_loss_and_grad(jm, x, f, normalization=1.0, w=WEIGHT):
    tri = taylor_tri_fn(jm, 2)
    xj, fj = jnp.asarray(x), jnp.asarray(f)

    def mse(p):
        _, _, hdiag = tri(p, xj)
        r = (-(hdiag[:, 0, 0] + hdiag[:, 0, 1]) - fj) / normalization
        return jnp.mean(r * r)

    loss = lambda p: w * mse(p)
    g = _ravel(jax.grad(loss)(jm.params))
    return float(loss(jm.params)), float(mse(jm.params)), g


def _plain_loss_and_grad(pnp, x, f, normalization=1.0, n_valid=None,
                         n_mean=None):
    params = params_from_numpy(pnp)
    flat = [t.requires_grad_(True) for p in params for t in (p["kernel"], p["bias"])]
    loss, mse = mb.poisson_residual_weighted_obj_plain(
        params, torch.as_tensor(x), torch.as_tensor(f), WEIGHT,
        normalization, n_valid, n_mean)
    assert not mse.requires_grad
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    return (float(loss.detach()), float(mse),
            torch.cat([g.reshape(-1) for g in grads]).numpy())


@pytest.mark.parametrize("normalization", [1.0, 3.0])
def test_plain_weighted_obj_matches_jax_grad(normalization):
    jm, pnp, x, f = _case(200, 1)
    l_ref, m_ref, g_ref = _jax_loss_and_grad(jm, x, f, normalization)
    l, m, g = _plain_loss_and_grad(pnp, x, f, normalization)
    np.testing.assert_allclose(l, l_ref, rtol=1e-12)
    np.testing.assert_allclose(m, m_ref, rtol=1e-12)
    np.testing.assert_allclose(g, g_ref, rtol=1e-9, atol=1e-12)


def test_plain_masked_equals_truncated_batch():
    """n_valid masks the tail; with n_mean = n_valid the result is the
    JAX reference on the first n_valid rows."""
    jm, pnp, x, f = _case(131, 4)
    m_valid = 97
    l_ref, m_ref, g_ref = _jax_loss_and_grad(jm, x[:m_valid], f[:m_valid])
    l, m, g = _plain_loss_and_grad(pnp, x, f, 1.0, m_valid, m_valid)
    np.testing.assert_allclose(l, l_ref, rtol=1e-12)
    np.testing.assert_allclose(m, m_ref, rtol=1e-12)
    np.testing.assert_allclose(g, g_ref, rtol=1e-9, atol=1e-12)


def test_plain_mse_gradient_matches_jax():
    """poisson_residual_mse_plain differentiates like the weighted
    objective (÷ the weight)."""
    jm, pnp, x, f = _case(150, 6)
    _, m_ref, g_ref = _jax_loss_and_grad(jm, x, f, 3.0, w=1.0)
    params = params_from_numpy(pnp)
    flat = [t.requires_grad_(True) for p in params for t in (p["kernel"], p["bias"])]
    mse = mb.poisson_residual_mse_plain(params, torch.as_tensor(x),
                                        torch.as_tensor(f), 3.0)
    assert mse.requires_grad and mse.dim() == 0
    g = torch.autograd.grad(mse, flat, materialize_grads=True)
    np.testing.assert_allclose(float(mse.detach()), m_ref, rtol=1e-12)
    np.testing.assert_allclose(torch.cat([t.reshape(-1) for t in g]).numpy(),
                               g_ref, rtol=1e-9, atol=1e-12)
    # the head bias does not enter Δu: its gradient is exactly zero
    assert not torch.any(g[-1])


def test_plain_matches_pallas_one_pass_kernel_interpret():
    """Once, small: the Pallas one-pass kernel (interpret mode on the CPU)
    with a masked tail, n = 300, n_valid = 250, normalization 2."""
    from tpinn.pallas import poisson_residual_weighted_obj as pallas_obj

    jm, pnp, x, f = _case(300, 8)
    n_valid = 250
    xj, fj = jnp.asarray(x), jnp.asarray(f)
    obj = lambda p: pallas_obj(p, xj, fj, WEIGHT, normalization=2.0,
                               np_tile=256, interpret=True, n_valid=n_valid,
                               n_mean=n_valid)
    l_ref, m_ref = obj(jm.params)
    g_ref = _ravel(jax.grad(lambda p: obj(p)[0])(jm.params))
    l, m, g = _plain_loss_and_grad(pnp, x, f, 2.0, n_valid, n_valid)
    np.testing.assert_allclose(l, float(l_ref), rtol=1e-12)
    np.testing.assert_allclose(m, float(m_ref), rtol=1e-12)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# autograd.Function contracts, the kernel wrappers replaced by plain math
# ---------------------------------------------------------------------------


def _plain_bwd(params, x, f, gbar, normalization=1.0, n_valid=None,
               n_mean=None, with_loss=False):
    """What kernel 3 returns, computed with autograd on the CPU."""
    with torch.enable_grad():
        leaves = [{k: p[k].detach().clone().requires_grad_(True)
                   for k in ("kernel", "bias")} for p in params]
        mse = mb.poisson_residual_mse_plain(leaves, x, f, normalization,
                                            n_valid, n_mean)
        loss = gbar[0] * mse
        flat = [t for p in leaves for t in (p["kernel"], p["bias"])]
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    dparams = [{"kernel": grads[i], "bias": grads[i + 1]}
               for i in range(0, len(grads), 2)]
    return dparams, mse.detach(), (loss.detach() if with_loss else None)


def _plain_fwd(params, x, f, normalization=1.0, n_valid=None, n_mean=None):
    with torch.no_grad():
        return mb.poisson_residual_mse_plain(params, x, f, normalization,
                                             n_valid, n_mean)


@pytest.fixture
def fake_kernels(monkeypatch):
    calls = {"bwd": 0, "fwd": 0}

    def bwd(*a, **k):
        calls["bwd"] += 1
        return _plain_bwd(*a, **k)

    def fwd(*a, **k):
        calls["fwd"] += 1
        return _plain_fwd(*a, **k)

    monkeypatch.setattr(mb, "poisson_residual_bwd", bwd)
    monkeypatch.setattr(mb, "poisson_residual_fwd", fwd)
    return calls


def _tensors(n, seed):
    _, pnp, x, f = _case(n, seed, width=16, depth=2)
    params = params_from_numpy(pnp)
    flat = [t.requires_grad_(True) for p in params for t in (p["kernel"], p["bias"])]
    return params, flat, torch.as_tensor(x), torch.as_tensor(f)


def test_weighted_objective_function_contract(fake_kernels):
    params, flat, x, f = _tensors(64, 3)
    spec = mb._PoissonSpec(2.0, None, None,
                           torch.tensor([WEIGHT], dtype=torch.float64))
    loss, mse = mb._PoissonWeightedObjective.apply(x, f, spec, *flat)
    assert fake_kernels["bwd"] == 1
    assert loss.requires_grad and not mse.requires_grad
    g = 2.5
    grads = torch.autograd.grad(g * loss, flat)
    dparams, mse_ref, loss_ref = _plain_bwd(params, x, f, spec.weight, 2.0,
                                            with_loss=True)
    ref = [t for p in dparams for t in (p["kernel"], p["bias"])]
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), g * b.numpy(), rtol=1e-15)
    np.testing.assert_array_equal(mse.numpy(), mse_ref.numpy())
    np.testing.assert_array_equal(loss.detach().numpy(), loss_ref.numpy())


def test_residual_mse_function_contract(fake_kernels):
    params, flat, x, f = _tensors(64, 5)
    spec = mb._PoissonSpec(1.0, 50, 50)
    mse = mb._PoissonResidualMSE.apply(x, f, spec, *flat)
    assert fake_kernels == {"bwd": 0, "fwd": 1}
    grads = torch.autograd.grad(0.75 * mse, flat)
    assert fake_kernels == {"bwd": 1, "fwd": 1}
    ref = torch.autograd.grad(
        0.75 * mb.poisson_residual_mse_plain(params, x, f, 1.0, 50, 50), flat,
        materialize_grads=True)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-15)


# ---------------------------------------------------------------------------
# routing and argument checks
# ---------------------------------------------------------------------------


def test_cpu_tensor_takes_the_plain_version():
    params, _, x, f = _tensors(40, 1)
    l1, m1 = mb.poisson_residual_weighted_obj(params, x, f, WEIGHT)
    l2, m2 = mb.poisson_residual_weighted_obj_plain(params, x, f, WEIGHT)
    assert torch.equal(l1, l2) and torch.equal(m1, m2)
    # a (1,) weight tensor (what the fused objective keeps) routes the same
    l3, _ = mb.poisson_residual_weighted_obj(
        params, x, f[:, None], torch.tensor([WEIGHT], dtype=torch.float64))
    assert torch.equal(l1, l3)
    assert torch.equal(mb.poisson_residual_mse(params, x, f, 3.0),
                       mb.poisson_residual_mse_plain(params, x, f, 3.0))


def test_kernel_wrappers_refuse_cpu_and_other_devices():
    params, _, x, f = _tensors(16, 1)
    gbar = torch.tensor([WEIGHT], dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        mb.poisson_residual_bwd(params, x, f, gbar)
    with pytest.raises(ValueError, match="CUDA"):
        mb.poisson_residual_fwd(params, x, f)
    with pytest.raises(ValueError, match="no path"):
        mb.poisson_residual_weighted_obj(params, x.to("meta"), f, WEIGHT)


def test_mismatched_layout_raises():
    params, _, x, f = _tensors(16, 1)
    with pytest.raises(ValueError, match="forcing"):
        mb.poisson_residual_mse(params, x, f[:10])
    with pytest.raises(ValueError, match="scalar head"):
        mb.poisson_residual_mse(params_from_numpy(
            [{"kernel": np.zeros((2, 3)), "bias": np.zeros(3)}]), x, f)
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        mb.poisson_residual_mse(params, torch.zeros(16, 3), f)


@pytest.mark.parametrize("widths,ok", [
    ((2, 20, 20, 20, 1), True),          # the examples' net
    ((2, 64, 64, 1), True),
    ((2, 128, 1), False),                # wider than two neurons per lane
    ((2,) + (16,) * 8 + (1,), False),    # more than MAX_LAYERS layers
    ((2, 20, 3), False),                 # not a scalar head
    ((3, 20, 1), False),                 # inputs are (x, y)
])
def test_fits_poisson_kernel(widths, ok):
    assert mb.fits_poisson_kernel(widths) is ok


def test_poisson_block_plan_fits_two_blocks_per_sm():
    """The examples' 2-20-20-20-1 in float64 pads every hidden width to 24
    and the head to 8; n = 200 takes 8-point tiles (25 tiles, 40 stream
    rows, the head's two Hessian row blocks at rows 24-39), whose backward
    block needs 97,504 bytes (two blocks can share an SM; the forward block
    is smaller); the forcing rides as a third input column."""
    w = (2, 20, 20, 20, 1)
    lay = mb.tile_layout(w, 2, 8, True, 1, 1)
    assert lay["wp"] == [2, 24, 24, 24, 8] and lay["ld"] == [2, 28, 28, 28, 12]
    assert lay["R"] == 40
    assert lay["n_acc"] == sum((a + 1) * b for a, b in zip(w[:-1], w[1:])) + 1
    assert mb.plan_points(w, 2, 1, 1, 8, 200) == 8
    assert 8 * lay["total"] == 97_504 <= 113 * 1024
    assert mb.smem_elems(w, 2, 8, False, 1, 1) < lay["total"]
    assert mb.smem_elems(w, 2, 8, True, 1, 1) == \
        mb.smem_elems(w, 2, 8, True, 1, 0) + 2 * 8  # two forcing buffers
    assert mb.plan_points(w, 2, 1, 1, 8, 1 << 20) == 16
    # the NS layout is this one with three sums and no forcing column
    assert mb.smem_elems((2, 32, 32, 32, 3), 2, 8, True) == \
        mb.smem_elems((2, 32, 32, 32, 3), 2, 8, True, 3, 0)


def test_use_fused_routes_the_poisson_net_without_warning():
    model = MLP(2, 1, width=20, depth=3, seed=1, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert use_fused_pde_losses(model, False, 2)
        assert use_fused_pde_losses(MLP(2, 3, width=32, depth=3, device="cpu"),
                                    False, 2)


@pytest.mark.parametrize("dim_out,width,depth", [
    (1, 128, 2),   # Poisson head, too wide
    (3, 16, 9),    # NS head, too deep
    (2, 20, 3),    # a head no kernel takes
])
def test_use_fused_warns_for_a_net_no_kernel_takes(dim_out, width, depth):
    model = MLP(2, dim_out, width=width, depth=depth, device="cpu")
    with pytest.warns(UserWarning, match=r"widths \[2, .*plain PyTorch path"):
        assert use_fused_pde_losses(model, False, 2) is False


def test_use_fused_ineligible_net_is_silent():
    """An unsteady layout for a scalar head or a non-tanh net is not a
    fused-path candidate at all: no warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not use_fused_pde_losses(
            MLP(2, 1, width=20, depth=3, activation="sin", device="cpu"),
            False, 2)
        assert not use_fused_pde_losses(MLP(3, 3, device="cpu"), False, 3)


# ---------------------------------------------------------------------------
# the fused objective used by the Poisson cases
# ---------------------------------------------------------------------------


def _fused(n=48, normalization=1.0):
    model = MLP(2, 1, width=16, depth=2, seed=0, device="cpu",
                input_extents=[(0.0, W), (0.0, W)])
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, W, (n, 2)))
    f = torch.as_tensor(rng.normal(size=n))
    return model, x, f, FusedPoissonObjective(model, x, f, WEIGHT,
                                              normalization)


def test_fused_objective_value_and_gradient():
    model, x, f, fused = _fused(normalization=2.0)
    v = fused.loss_fn()()
    mse = mb.poisson_residual_mse_plain(model.params, x, f, 2.0).detach()
    assert float(v) == float(mse)
    g = torch.autograd.grad(WEIGHT * v, model.flat_params(),
                            materialize_grads=True)
    loss, _ = mb.poisson_residual_weighted_obj_plain(model.params, x, f,
                                                     WEIGHT, 2.0)
    ref = torch.autograd.grad(loss, model.flat_params(),
                              materialize_grads=True)
    for a, b in zip(g, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-16)


def test_fused_objective_one_call_per_parameter_state(monkeypatch):
    """One call per parameter state; an in-place update (same tensors, new
    version) recomputes; no_grad evaluations take the forward function."""
    model, x, f, fused = _fused()
    calls = {"obj": 0, "mse": 0}
    real_obj, real_mse = mb.poisson_residual_weighted_obj, mb.poisson_residual_mse

    def obj(*a, **k):
        calls["obj"] += 1
        return real_obj(*a, **k)

    def mse(*a, **k):
        calls["mse"] += 1
        return real_mse(*a, **k)

    monkeypatch.setattr(mb, "poisson_residual_weighted_obj", obj)
    monkeypatch.setattr(mb, "poisson_residual_mse", mse)
    fn = fused.loss_fn()
    first = float(fn())
    float(fn())
    assert calls == {"obj": 1, "mse": 0}
    with torch.no_grad():
        for p in model.flat_params():
            p.add_(0.01)
    second = float(fn())
    assert calls == {"obj": 2, "mse": 0} and second != first
    ref = float(mb.poisson_residual_mse_plain(model.params, x, f))
    assert second == ref
    with torch.no_grad():
        third = float(fn())
    assert calls == {"obj": 2, "mse": 1} and third == ref
