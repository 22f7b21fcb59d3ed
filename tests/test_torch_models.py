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
