"""Kernel 5's plain version and the TPINN_USE_PALLAS switch against the
JAX package.

``tpinn_torch.kernels.mlp_bundle.mlp_taylor_bundle_plain`` is held against
``tpinn.pallas.mlp_bundle.mlp_taylor_bundle`` in interpret mode (the TPU
kernel's own arithmetic, run on the CPU) in float64, with shared numpy
weights and points, d_in 2 and 3, d_out 1 and 3, 600 points on 256-point
tiles (so the reference pads its last tile).  Bar: max |Δ| ≤ 1e-13·max|ref|
per output (the two differ by a few units in the last place: the same
stream algebra, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.pallas.mlp_bundle import mlp_taylor_bundle as jax_bundle
from tpinn_torch.geometry import Normalization
from tpinn_torch.kernels import mlp_bundle as mb
from tpinn_torch.models import MLP
from tpinn_torch.pipeline import (
    NSPhysics,
    ResidualBundle,
    mass_residual,
    momentum_residual,
    neumann_residual,
    scaled_point_residual,
    use_fused_pde_losses,
    use_pallas_default,
)

torch.set_num_threads(1)

BAR = 1e-13


def _problem(d_in, d_out, n, seed, widths=(16, 16)):
    rng = np.random.default_rng(seed)
    sizes = (d_in,) + tuple(widths) + (d_out,)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        lim = np.sqrt(6.0 / (a + b))
        params.append({"kernel": rng.uniform(-lim, lim, (a, b)),
                       "bias": rng.uniform(-0.1, 0.1, b)})
    x = rng.uniform(-1.0, 1.0, (n, d_in))
    return params, x


def _torch_params(params):
    return [{k: torch.as_tensor(p[k]) for k in ("kernel", "bias")}
            for p in params]


@pytest.mark.parametrize("d_in,d_out,dim", [(2, 3, None), (2, 1, None),
                                            (3, 3, None), (3, 1, None),
                                            (3, 3, 2)])
def test_plain_matches_tpinn_interpret_kernel(d_in, d_out, dim):
    params, x = _problem(d_in, d_out, 600, 7 + d_in + d_out)
    ref = jax_bundle([{k: jnp.asarray(v) for k, v in p.items()}
                      for p in params], jnp.asarray(x), dim=dim, np_tile=256,
                     interpret=True)
    got = mb.mlp_taylor_bundle_plain(_torch_params(params),
                                     torch.as_tensor(x), dim)
    k = d_in if dim is None else dim
    shapes = [(600, d_out), (600, d_out, k), (600, d_out, k)]
    for name, r, g, shape in zip(("value", "jac", "hdiag"), ref, got, shapes):
        r = np.asarray(r)
        assert r.dtype == np.float64 and g.dtype == torch.float64
        assert tuple(g.shape) == r.shape == shape, name
        err = float(np.max(np.abs(g.numpy() - r)))
        assert err <= BAR * float(np.max(np.abs(r))), (name, err)


def test_wrapper_cpu_route_is_the_plain_version():
    params, x = _problem(2, 3, 50, 3)
    tp, tx = _torch_params(params), torch.as_tensor(x)
    before = dict(mb.LAUNCHES)
    got = mb.mlp_taylor_bundle(tp, tx)
    ref = mb.mlp_taylor_bundle_plain(tp, tx)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert mb.LAUNCHES == before  # the CPU route launches nothing


@pytest.mark.parametrize("widths,d_in,dim,match", [
    ((2, 8, 3), 2, 3, "dim=3"),
    ((2, 8, 3), 2, 0, "dim=0"),
    ((4, 8, 3), 4, None, "d_in=4"),
    ((2, 65, 3), 2, None, r"widths \[2, 65, 3\]"),
    ((2,) + (8,) * 8 + (3,), 2, None, "at most 8 layers"),
])
def test_shapes_kernel5_does_not_take_raise(widths, d_in, dim, match):
    """Shapes the CUDA kernel does not take raise on both routes, naming
    them, instead of quietly taking the plain path."""
    rng = np.random.default_rng(0)
    params = [{"kernel": torch.as_tensor(rng.normal(size=(a, b))),
               "bias": torch.zeros(b, dtype=torch.float64)}
              for a, b in zip(widths[:-1], widths[1:])]
    with pytest.raises(ValueError, match=match):
        mb.mlp_taylor_bundle(params, torch.zeros(4, d_in,
                                                 dtype=torch.float64), dim)


def _bundle_model(n=40):
    model = MLP(2, 3, width=16, depth=2, seed=4, device="cpu")
    x = torch.as_tensor(np.random.default_rng(2).uniform(0, 1, (n, 2)))
    return model, x


def test_residual_bundle_opt_in_gives_the_same_tensors():
    model, x = _bundle_model()
    phys = NSPhysics(conv=3100.0, visc=890.0)
    norm = Normalization(np.array([0.0, 500.0]), np.array([0.0, 250.0]),
                         np.array([-1e4, 1e4]))
    on = ResidualBundle(model, x, use_pallas=True)
    off = ResidualBundle(model, x, use_pallas=False)
    with torch.no_grad():
        for a, b in zip(on.compute(), off.compute()):
            assert torch.equal(a, b)
        assert torch.equal(mass_residual(on, norm), mass_residual(off, norm))
        for k in (0, 1):
            assert torch.equal(momentum_residual(on, k, phys, norm),
                               momentum_residual(off, k, phys, norm))
            assert torch.equal(neumann_residual(on, k, 0, phys, norm, 1.0),
                               neumann_residual(off, k, 0, phys, norm, 1.0))


@pytest.mark.parametrize("env", [None, "1", "0", "false", "False", "yes"])
def test_use_pallas_resolution_matches_tpinn(env, monkeypatch):
    from tpinn.models import MLP as JaxMLP
    from tpinn.pipeline import ResidualBundle as JaxBundle

    if env is None:
        monkeypatch.delenv("TPINN_USE_PALLAS", raising=False)
    else:
        monkeypatch.setenv("TPINN_USE_PALLAS", env)
    model, x = _bundle_model(4)
    jm = JaxMLP(2, 3, width=4, depth=1, dtype=jnp.float64)
    jx = jnp.asarray(x.numpy())
    assert ResidualBundle(model, x).use_pallas is JaxBundle(jm, jx).use_pallas
    assert use_pallas_default() is JaxBundle(jm, jx).use_pallas
    # the argument wins over the variable, in both packages
    for arg in (True, False):
        assert (ResidualBundle(model, x, use_pallas=arg).use_pallas
                is JaxBundle(jm, jx, use_pallas=arg).use_pallas is arg)


@pytest.mark.parametrize("env,fused", [(None, True), ("1", True),
                                       ("0", False), ("false", False),
                                       ("False", False)])
def test_use_pallas_zero_switches_fused_pde_losses_off(env, fused,
                                                       monkeypatch):
    if env is None:
        monkeypatch.delenv("TPINN_USE_PALLAS", raising=False)
    else:
        monkeypatch.setenv("TPINN_USE_PALLAS", env)
    model = MLP(2, 3, width=32, depth=3, device="cpu")
    assert use_fused_pde_losses(model, False, 2) is fused


def test_reverse_mode_through_the_kernel_route_raises():
    """As in the JAX package, whose Taylor-bundle kernel has no VJP: a
    gradient through the opt-in bundle raises in both."""
    model, x = _bundle_model(8)
    norm = Normalization(np.array([0.0, 1.0]), np.array([0.0, 1.0]),
                         np.array([-2.0, 2.0]))
    loss = torch.mean(mass_residual(ResidualBundle(model, x,
                                                   use_pallas=True), norm) ** 2)
    with pytest.raises(RuntimeError, match="TPINN_USE_PALLAS"):
        torch.autograd.grad(loss, model.flat_params(),
                            materialize_grads=True)
    # the plain route differentiates
    loss = torch.mean(mass_residual(ResidualBundle(model, x,
                                                   use_pallas=False), norm) ** 2)
    assert all(torch.isfinite(g).all() for g in
               torch.autograd.grad(loss, model.flat_params(),
                                   materialize_grads=True))

    params, xn = _problem(2, 3, 8, 1)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]

    def jloss(p):
        value, jac, _ = jax_bundle(p, jnp.asarray(xn), interpret=True)
        return jnp.sum(value ** 2) + jnp.sum(jac ** 2)

    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(jloss)(jp)


def test_scaled_point_residual_scales_value_and_gradient():
    fn = lambda params, xi, rhs: params[0] * xi.sum() - rhs
    w = scaled_point_residual(fn)
    p = [torch.tensor(2.0, dtype=torch.float64)]
    xi = torch.tensor([1.0, 3.0], dtype=torch.float64)
    r = torch.tensor(1.0, dtype=torch.float64)
    s = torch.tensor(0.5, dtype=torch.float64)
    assert float(w(p, xi, r, s)) == 0.5 * float(fn(p, xi, r))
    g = torch.func.grad(lambda q: w([q], xi, r, torch.tensor(0.0)))(p[0])
    assert float(g) == 0.0
