"""tpinn_torch.models and bridge against tpinn.models: the same θ gives the
same forward, and the layer-0 input-extent fold is the same map."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.models import MLP as JaxMLP
from tpinn_torch.bridge import params_from_numpy, params_to_numpy
from tpinn_torch.models import MLP, Model

torch.set_num_threads(1)


def _jax_params_np(model):
    return [{k: np.asarray(p[k]) for k in ("kernel", "bias")}
            for p in model.params]


@pytest.mark.parametrize("d_in,width,depth", [(2, 32, 3), (3, 16, 2), (2, 8, 1)])
def test_apply_matches_tpinn(d_in, width, depth):
    jm = JaxMLP(d_in, 3, width=width, depth=depth, seed=3, dtype=jnp.float64)
    pnp = _jax_params_np(jm)
    x = np.random.default_rng(0).uniform(-1, 1, (257, d_in))
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    tm = MLP(d_in, 3, width=width, depth=depth, device="cpu")
    got = tm.apply(params_from_numpy(pnp), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_bridge_round_trip_and_set_params():
    jm = JaxMLP(2, 3, width=8, depth=2, seed=1, dtype=jnp.float64)
    pnp = _jax_params_np(jm)
    tm = MLP(2, 3, width=8, depth=2, device="cpu")
    tm.set_params(params_from_numpy(pnp))
    back = params_to_numpy(tm.params)
    for a, b in zip(back, pnp):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(a[k], b[k])
    assert [p.shape for p in tm.flat_params()] == [
        (2, 8), (8,), (8, 8), (8,), (8, 3), (3,)]


def test_glorot_init_layout_and_range():
    m = MLP(2, 3, width=32, depth=3, seed=0, device="cpu")
    assert m.layer_sizes == (2, 32, 32, 32, 3)
    for p, (fi, fo) in zip(m.params, [(2, 32), (32, 32), (32, 32), (32, 3)]):
        assert p["kernel"].shape == (fi, fo) and p["kernel"].dtype == torch.float64
        lim = np.sqrt(6.0 / (fi + fo))
        assert float(p["kernel"].detach().abs().max()) <= lim
        assert torch.all(p["bias"] == 0)
    # a seed gives the same weights every time
    m2 = MLP(2, 3, width=32, depth=3, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.flat_params(), m2.flat_params()))


@pytest.mark.parametrize("extents", [[(0.0, 1.0), (0.0, 0.1)],
                                     [(0.0, 2.0), (-1.0, 1.0), (0.0, 0.5)]])
def test_input_extent_fold_is_normalization(extents):
    """Layer-0 fold: x @ Ŵ0 + b̂0 equals the unfolded layer on the
    normalized input (x − mid)/half, as in tpinn.models.Model.init."""
    d = len(extents)
    g = torch.Generator().manual_seed(5)
    plain = Model([d, 8, 3], generator=g, device="cpu")
    g = torch.Generator().manual_seed(5)
    folded = Model([d, 8, 3], generator=g, device="cpu", input_extents=extents)
    x = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (50, d)))
    mid = torch.tensor([(lo + hi) / 2 for lo, hi in extents],
                       dtype=torch.float64)
    half = torch.tensor([(hi - lo) / 2 for lo, hi in extents],
                        dtype=torch.float64)
    np.testing.assert_allclose(folded(x).detach().numpy(),
                               plain((x - mid) / half).detach().numpy(),
                               rtol=1e-12, atol=1e-12)
    # the same fold applied by tpinn to the same raw kernel
    from tpinn.models import Model as JaxModel

    jm = JaxModel([d, 8, 3], seed=0, dtype=jnp.float64)
    raw = _jax_params_np(jm)
    jm_f = JaxModel([d, 8, 3], seed=0, dtype=jnp.float64, input_extents=extents)
    np.testing.assert_allclose(
        np.asarray(jm_f.params[0]["kernel"]),
        raw[0]["kernel"] / half.numpy()[:, None], rtol=1e-15)


def test_plain_tanh_predicate():
    assert MLP(2, 3, width=4, depth=1, device="cpu").is_plain_tanh()
    assert not MLP(2, 3, width=4, depth=1, activation="sin",
                   device="cpu").is_plain_tanh()


def test_model_raises_without_device_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MLP(2, 3, width=4, depth=1)


def test_set_params_refuses_a_short_list():
    m = MLP(2, 3, width=8, depth=3, device="cpu")
    before = [t.clone() for t in m.flat_params()]
    with pytest.raises(ValueError, match="1 layers given for a model of 4"):
        m.set_params(m.params[:1])
    assert all(torch.equal(a, b) for a, b in zip(before, m.flat_params()))


@pytest.mark.parametrize("layer,key,shape", [(1, "kernel", (8,)),
                                             (1, "kernel", (8, 4)),
                                             (3, "bias", (1,))])
def test_set_params_refuses_a_wrong_shape(layer, key, shape):
    """A mis-shaped array is not broadcast over the parameter: the error
    names the layer, the key and both shapes, and nothing is copied."""
    m = MLP(2, 3, width=8, depth=3, device="cpu")
    before = [t.clone() for t in m.flat_params()]
    params = [{k: t.detach().clone() for k, t in p.items()} for p in m.params]
    params[layer][key] = torch.ones(shape, dtype=torch.float64)
    want = tuple(m.params[layer][key].shape)
    with pytest.raises(ValueError, match=rf"layer {layer} '{key}' has shape "
                       rf"\({shape[0]},.*the model's is \({want[0]},"):
        m.set_params(params)
    assert all(torch.equal(a, b) for a, b in zip(before, m.flat_params()))


def test_forward_casts_numpy_and_float32_batches():
    """As tpinn's Model.__call__: any array is cast to the model's dtype."""
    jm = JaxMLP(2, 3, width=8, depth=2, seed=2, dtype=jnp.float64)
    tm = MLP(2, 3, width=8, depth=2, device="cpu")
    tm.set_params(params_from_numpy(_jax_params_np(jm)))
    x = np.random.default_rng(3).uniform(-1, 1, (17, 2))
    ref = tm(torch.as_tensor(x)).detach()
    out_np = tm(x)
    assert out_np.dtype == torch.float64
    assert torch.equal(out_np.detach(), ref)
    np.testing.assert_allclose(out_np.detach().numpy(),
                               np.asarray(jm(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-12)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    out32 = tm(x32).detach()
    assert out32.dtype == torch.float64
    assert torch.equal(out32, tm(x32.double()).detach())
    np.testing.assert_allclose(out32.numpy(),
                               np.asarray(jm(jnp.asarray(x, jnp.float32))),
                               rtol=1e-12, atol=1e-12)


def test_forward_keeps_the_graph_of_a_watched_batch():
    tm = MLP(2, 3, width=8, depth=2, device="cpu")
    x = torch.rand(5, 2, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(tm(x)[:, 0].sum(), x)
    assert g.shape == (5, 2) and torch.isfinite(g).all()


@pytest.mark.parametrize("name", ["tanh", "relu", "gelu", "sin", "linear"])
def test_activations_match_tpinn(name):
    """Every activation equals tpinn's in float64 at 1e-15 (gelu is
    jax.nn.gelu's default, the tanh approximation), and a model of it
    gives tpinn's forward at 1e-13."""
    from tpinn.models import _ACTIVATIONS as JAX_ACTIVATIONS
    from tpinn_torch.models import _ACTIVATIONS

    x = np.linspace(-3.0, 3.0, 13)
    ref = np.asarray(JAX_ACTIVATIONS[name](jnp.asarray(x)))
    got = _ACTIVATIONS[name](torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    jm = JaxMLP(2, 3, width=16, depth=3, seed=4, activation=name,
                dtype=jnp.float64)
    tm = MLP(2, 3, width=16, depth=3, activation=name, device="cpu")
    tm.set_params(params_from_numpy(_jax_params_np(jm)))
    xb = np.random.default_rng(5).uniform(-2, 2, (65, 2))
    np.testing.assert_allclose(tm(xb).detach().numpy(),
                               np.asarray(jm(jnp.asarray(xb))), rtol=0,
                               atol=1e-13)
