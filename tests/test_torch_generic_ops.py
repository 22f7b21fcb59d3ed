"""The port's generic per-point operators (``torch.func``, a jvp of a jvp
for second derivatives) against tpinn's (``jax.grad`` / ``jacfwd`` / jvp
and Taylor-mode ``jet``), in float64 on the CPU, on 2-8-8-3 nets of four
activations at 1e-12 of each output's largest magnitude.

tpinn's jet cannot take ``jax.nn.relu`` (its custom_jvp rule leaks a tracer
out of ``jet``), so for relu the second-order operators are held against
``jax.hessian`` of tpinn's per-point forward instead.  Then the non-tanh
``ResidualBundle`` and ``taylor_tri_fn`` (the generic path) against
tpinn's, a sin net's residuals differentiated in the parameters (Adam's
gradient, the LM fast Gram's per-point rows), and a sin-net Poiseuille
driver's Adam + LM round, whose fast Gram the point residuals pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn import operators as jops
from tpinn.models import Model as JaxModel
from tpinn.pipeline import ResidualBundle as JaxBundle
from tpinn.pipeline import taylor_tri_fn as jax_tri_fn
from tpinn_torch import operators as ops
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.models import Model
from tpinn_torch.pipeline import ResidualBundle, taylor_tri_fn

torch.set_num_threads(1)

BAR = 1e-12
ACTIVATIONS = ["tanh", "sin", "gelu", "relu"]
OPERATORS = ["grad", "jacobian", "divergence", "laplacian", "hessian_diag",
             "taylor_bundle"]


def _pair(act, widths=(2, 8, 8, 3), seed=0):
    jm = JaxModel(list(widths), activation=act, seed=seed, dtype=jnp.float64)
    tm = Model(list(widths), activation=act, device="cpu")
    tm.set_params(params_from_numpy(
        [{k: np.asarray(p[k]) for k in ("kernel", "bias")}
         for p in jm.params]))
    return jm, tm


def _points(n=11, d=2, seed=1):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (n, d))


def _close(got, ref):
    got = [np.asarray(g.detach().numpy() if torch.is_tensor(g) else g)
           for g in (got if isinstance(got, tuple) else (got,))]
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=BAR * max(np.abs(r).max(), 1e-300))


def _jax_second_order(f, name, dim):
    """tpinn's operator, or for relu (no jet) its jax.hessian value."""
    if name == "laplacian":
        return lambda xi: jnp.trace(jax.hessian(
            lambda z: f(z).reshape(()))(xi)[:dim, :dim])
    if name == "hessian_diag":
        return lambda xi: jnp.diagonal(jax.hessian(
            lambda z: f(z).reshape(()))(xi))[:dim]

    def bundle(xi):
        H = jax.hessian(f)(xi)
        return (f(xi), jax.jacfwd(f)(xi)[:, :dim],
                jnp.diagonal(H, axis1=1, axis2=2)[:, :dim])

    return bundle


@pytest.mark.parametrize("name", OPERATORS)
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_operator_matches_tpinn(act, name):
    jm, tm = _pair(act)
    x = _points()
    jf = lambda xi: jm.apply_single(jm.params, xi)
    tf = lambda xi: tm.apply(tm.params, xi[None, :])[0]
    j0 = lambda xi: jf(xi)[0]
    t0 = lambda xi: tf(xi)[0]
    xs, xt = jnp.asarray(x), torch.as_tensor(x)
    no_jet = act == "relu" and name in ("laplacian", "hessian_diag",
                                         "taylor_bundle")
    if name == "grad":
        _close(ops.vgrad(t0, xt), jops.vgrad(j0, xs))
        _close(ops.gradient_fn(t0)(xt[3]), jops.gradient_fn(j0)(xs[3]))
    elif name == "jacobian":
        _close(torch.func.vmap(ops.jacobian_fn(tf))(xt),
               jax.vmap(jops.jacobian_fn(jf))(xs))
    elif name == "divergence":
        _close(ops.vdivergence(tf, xt, 2), jops.vdivergence(jf, xs, 2))
    elif name == "laplacian":
        ref = (jax.vmap(_jax_second_order(j0, name, 2))(xs) if no_jet
               else jops.vlaplacian(j0, xs, 2))
        _close(ops.vlaplacian(t0, xt, 2), ref)
    elif name == "hessian_diag":
        ref_fn = (_jax_second_order(j0, name, 2) if no_jet
                  else jops.hessian_diag_fn(j0, 2))
        _close(torch.func.vmap(ops.hessian_diag_fn(t0, 2))(xt),
               jax.vmap(ref_fn)(xs))
    else:
        ref = (jax.vmap(_jax_second_order(jf, name, 2))(xs) if no_jet
               else jops.vtaylor_bundle(jf, xs, 2))
        _close(ops.vtaylor_bundle(tf, xt, 2), ref)
        # one point, and a bundle over fewer columns than inputs
        _close(ops.taylor_bundle(tf, 1)(xt[2]),
               _jax_second_order(jf, name, 1)(xs[2])
               if no_jet else jops.taylor_bundle(jf, 1)(xs[2]))


def test_relu_has_no_jet_in_tpinn():
    """Why relu's second-order references above are jax.hessian's."""
    jm, _ = _pair("relu")
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jops.vtaylor_bundle(lambda xi: jm.apply_single(jm.params, xi),
                            jnp.asarray(_points()), 2)


@pytest.mark.parametrize("act,d_in", [("sin", 2), ("gelu", 2), ("sin", 3)])
def test_generic_bundle_and_tri_match_tpinn(act, d_in):
    jm, tm = _pair(act, widths=(d_in, 16, 16, 3), seed=2)
    x = _points(n=23, d=d_in, seed=4)
    ref = JaxBundle(jm, jnp.asarray(x), unsteady=d_in == 3).compute()
    bundle = ResidualBundle(tm, torch.as_tensor(x), unsteady=d_in == 3)
    _close(bundle.compute(), tuple(ref))
    assert bundle.compute()[0] is bundle.compute()[0]  # memoized
    tri_ref = jax_tri_fn(jm, d_in)(jm.params, jnp.asarray(x[:5]))
    _close(taylor_tri_fn(tm, d_in)(tm.params, torch.as_tensor(x[:5])),
           tuple(tri_ref))
    # the opt-in does not send a non-tanh net to kernel 5's tanh
    on = ResidualBundle(tm, torch.as_tensor(x), unsteady=d_in == 3,
                        use_pallas=True)
    _close(on.compute(), tuple(ref))


def test_generic_residuals_differentiate_in_the_parameters():
    """A sin net's bundle carries Adam's gradient, and its per-point rows
    (vmap of grad over the nested jvps) give the LM Gram's rows: both
    against tpinn's at 1e-12."""
    jm, tm = _pair("sin", widths=(2, 8, 8, 3), seed=3)
    x = _points(n=9)

    def j_loss(params):
        _, jac, hd = jax_tri_fn(jm, 2)(params, jnp.asarray(x))
        return jnp.sum(hd ** 2) + jnp.sum(jac ** 2)

    g_ref = jax.grad(j_loss)(jm.params)
    _, jac, hd = ResidualBundle(tm, torch.as_tensor(x)).compute()
    g = torch.autograd.grad(torch.sum(hd ** 2) + torch.sum(jac ** 2),
                            tm.flat_params(), materialize_grads=True)
    for (gk, gb), p in zip(zip(g[0::2], g[1::2]), g_ref):
        _close((gk, gb), (p["kernel"], p["bias"]))
    tri = taylor_tri_fn(tm, 2)
    flat = torch.cat([t.detach().reshape(-1) for p in tm.params
                      for t in (p["bias"], p["kernel"])])

    def unravel(th):
        out, off = [], 0
        for p in tm.params:
            layer = {}
            for key in ("bias", "kernel"):
                n = p[key].numel()
                layer[key] = th[off:off + n].reshape(p[key].shape)
                off += n
            out.append(layer)
        return out

    row = lambda th, xi: tri(unravel(th), xi[None, :])[2][0, 0, 0]
    G = torch.func.vmap(torch.func.grad(row), in_dims=(None, 0))(
        flat, torch.as_tensor(x))
    from jax.flatten_util import ravel_pytree

    vec, junravel = ravel_pytree(jm.params)
    jrow = lambda th, xi: jax_tri_fn(jm, 2)(junravel(th), xi[None, :])[2][
        0, 0, 0]
    _close(G, jax.vmap(jax.grad(jrow), in_axes=(None, 0))(
        vec, jnp.asarray(x)))


def test_sin_net_driver_runs_adam_and_lm(tmp_path):
    """A 2-16-16-16-3 sin net on the Poiseuille case through the generic
    bundles (the driver's model replaced and its losses built anew on it):
    its point residuals pass the θ0 check (the fast Gram), and Adam 5 +
    LM 2 reduce the loss."""
    from tests import test_torch_lm as lm
    from tpinn_torch.cases import poiseuille_flow as pf
    from tpinn_torch.config import SimulationOptions
    from tpinn_torch.driver import StandardNSDriver
    from tpinn_torch.models import MLP

    spec = pf.build_spec()
    opts = SimulationOptions(**{**pf.default_options().__dict__, **lm.SMALL})
    d = StandardNSDriver(spec, opts, base_dir=str(tmp_path),
                         save_results=False, seed=0, second_round="lm",
                         adam_epochs=5, device="cpu")
    d.model = MLP(spec.dim_in, 3, width=16, activation="sin", seed=0,
                  input_extents=spec.extents, dtype=d.dtype, device="cpu")
    d.losses, d.losses_test = d._build_losses()
    assert not d.model.is_plain_tanh()
    pb = d.train(epochs=2, callbacks=False)
    assert pb.history.round_names == ["keras_Adam", "jax_LM"]
    assert pb.lm_used_fast_gram is True
    h = pb.history.loss_global
    assert np.isfinite(h).all() and h[-1] < h[pb.history.rounds_idx.index(2)]
