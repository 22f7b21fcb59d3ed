"""tpinn_torch.operators.mlp_taylor_batched against tpinn's closed-form
propagation and its Taylor-mode (jet) bundle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.models import MLP as JaxMLP
from tpinn.operators import mlp_taylor_batched as jax_taylor
from tpinn.operators import vtaylor_bundle
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.operators import mlp_taylor_batched

torch.set_num_threads(1)


def _setup(d_in, width, depth, n, seed):
    jm = JaxMLP(d_in, 3, width=width, depth=depth, seed=seed, dtype=jnp.float64)
    pnp = [{k: np.asarray(p[k]) for k in ("kernel", "bias")} for p in jm.params]
    x = np.random.default_rng(seed).uniform(0, 1, (n, d_in))
    return jm, pnp, x


@pytest.mark.parametrize("d_in", [2, 3])
def test_taylor_matches_tpinn_closed_form(d_in):
    jm, pnp, x = _setup(d_in, 32, 3, 300, d_in)
    ref = jax_taylor(jm.params, jnp.asarray(x), d_in)
    got = mlp_taylor_batched(params_from_numpy(pnp), torch.as_tensor(x), d_in)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("d_in", [2, 3])
def test_taylor_matches_jet(d_in):
    jm, pnp, x = _setup(d_in, 16, 2, 64, 10 + d_in)
    f = lambda xi: jm.apply_single(jm.params, xi)
    ref = vtaylor_bundle(f, jnp.asarray(x), d_in)
    got = mlp_taylor_batched(params_from_numpy(pnp), torch.as_tensor(x), d_in)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


def test_taylor_matches_torch_autograd():
    """Jacobian and Hessian diagonal agree with torch.func derivatives."""
    _, pnp, x = _setup(2, 8, 2, 5, 4)
    params = params_from_numpy(pnp)
    from tpinn_torch.models import Model

    m = Model([2, 8, 8, 3], device="cpu")
    value, jac, hdiag = mlp_taylor_batched(params, torch.as_tensor(x), 2)
    f = lambda xi: m.apply(params, xi[None])[0]
    for i in range(x.shape[0]):
        xi = torch.as_tensor(x[i])
        J = torch.func.jacfwd(f)(xi)
        H = torch.func.jacfwd(torch.func.jacrev(f))(xi)
        np.testing.assert_allclose(jac[i].numpy(), J.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(
            hdiag[i].numpy(), torch.diagonal(H, dim1=1, dim2=2).numpy(),
            rtol=1e-10, atol=1e-12)
