"""The tape surface (tpinn_torch.tape, tens_style) against the JAX
package's tape on the same weights and points, in float64.

tpinn's tape captures per-point functions and differentiates them with
jet/vmap; the port's tape is PyTorch autograd.  The input derivatives agree
to rtol 1e-12 of each array's scale; the parameter gradient of the mixed
Poisson case's Neumann loss (∂u/∂x − g on the x-edges) agrees with
``jax.grad`` of tpinn's closure at rtol 1e-9 / atol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpinn as tns
import tpinn_torch as ns
from tpinn.experimental.physics import tens_style as jts
from tpinn.models import MLP as JaxMLP
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.experimental.physics import tens_style as ts
from tpinn_torch.models import MLP

torch.set_num_threads(1)

W = 2 * np.pi


def _models(d_out, seed=3, n=64):
    jm = JaxMLP(2, d_out, width=16, depth=2, seed=seed, dtype=jnp.float64,
                input_extents=[(0.0, W), (0.0, W)])
    tm = MLP(2, d_out, width=16, depth=2, device="cpu")
    tm.set_params(params_from_numpy(jm.params))
    x = np.random.default_rng(seed).uniform(0.0, W, (n, 2))
    return jm, tm, x


def _close(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=rtol,
                               atol=rtol * np.max(np.abs(ref)))


def _jax_op(jm, x, op, *args):
    xj = jnp.asarray(x)
    with tns.GradientTape(persistent=True) as tape:
        tape.watch(xj)
        u = jm(xj)
        return np.asarray(op(tape, u, xj, *args).value)


def _torch_op(tm, x, op, *args):
    xt = torch.as_tensor(x)
    with ns.GradientTape(persistent=True) as tape:
        tape.watch(xt)
        u = tm(xt)
        out = op(tape, u, xt, *args)
    return out


def test_gradient_scalar_matches_tpinn():
    jm, tm, x = _models(1)
    got = _torch_op(tm, x, ts.gradient_scalar)
    assert got.shape == (64, 2)
    _close(got, _jax_op(jm, x, jts.gradient_scalar))


def test_laplacian_scalar_matches_tpinn():
    jm, tm, x = _models(1)
    got = _torch_op(tm, x, ts.laplacian_scalar, 2)
    assert got.shape == (64,)
    _close(got, _jax_op(jm, x, jts.laplacian_scalar, 2))


def test_divergence_and_vector_laplacian_match_tpinn():
    jm, tm, x = _models(3)
    _close(_torch_op(tm, x, ts.divergence_vector, 2),
           _jax_op(jm, x, jts.divergence_vector, 2))
    got = _torch_op(tm, x, ts.laplacian_vector, 2)
    assert got.shape == (64, 3)
    _close(got, _jax_op(jm, x, jts.laplacian_vector, 2))


def test_tape_differentiates_under_no_grad():
    """The logged evaluations run under torch.no_grad: the tape switches
    grad on inside and restores the mode (and the batch's flag) after."""
    jm, tm, x = _models(1)
    ref = _jax_op(jm, x, jts.laplacian_scalar, 2)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        with ns.GradientTape() as tape:
            tape.watch(xt)
            lap = ts.laplacian_scalar(tape, tm(xt), xt, 2)
        assert not torch.is_grad_enabled()
        r = lap - 1.0
    assert not xt.requires_grad and not r.requires_grad
    _close(lap, ref)


def test_watch_is_scoped_and_unwatched_input_raises():
    _, tm, x = _models(1)
    xt = torch.as_tensor(x)
    tape = ns.GradientTape()
    with pytest.raises(RuntimeError, match="outside"):
        tape.watch(xt)
    with ns.GradientTape() as tape:
        u = tm(xt)
        with pytest.raises(ValueError, match="watched"):
            ts.gradient_scalar(tape, u, xt)
        tape.watch(xt)
        assert xt.requires_grad
    assert not xt.requires_grad


def test_neumann_loss_parameter_gradient_matches_jax_grad():
    """The mixed Poisson case's BC_N loss, mean((∂u/∂x − g)²), and its
    gradient in every parameter, against jax.grad of tpinn's closure."""
    jm, tm, x = _models(1, seed=5, n=40)
    x[:20, 0], x[20:, 0] = 0.0, W
    g = np.cos(x[:, 0]) * np.sin(x[:, 1])
    xj, gj = jnp.asarray(x), jnp.asarray(g)

    def jax_closure():
        with tns.GradientTape(persistent=True) as tape:
            tape.watch(xj)
            u = jm(xj)
            du = jts.gradient_scalar(tape, u, xj)
        return du[:, 0] - gj

    jloss = tns.LossMeanSquares("BC_N", jax_closure)

    def jax_value(p):
        with jm.variables.bind(p):
            return jloss.raw_value()

    v_ref, g_ref = jax.value_and_grad(jax_value)(jm.params)

    xt, gt = torch.as_tensor(x), torch.as_tensor(g)

    def closure():
        with ns.GradientTape(persistent=True) as tape:
            tape.watch(xt)
            u = tm(xt)
            du = ts.gradient_scalar(tape, u, xt)
        return du[:, 0] - gt

    loss = ns.LossMeanSquares("BC_N", closure).raw_value()
    grads = torch.autograd.grad(loss, tm.flat_params(), materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(v_ref), rtol=1e-12)
    ref = [np.asarray(p[k]) for p in g_ref for k in ("kernel", "bias")]
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12)
