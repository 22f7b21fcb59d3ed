"""The port's entry points (tpinn_torch/entry.py) against the JAX package's
(__graft_entry__.py):

* ``entry()``: the same 4,096 × 2 draw, bit for bit; the forward step on
  the JAX package's θ0 (carried through numpy) at rtol 1e-5 in float32 and
  1e-12 in float64 (the JAX package under x64, as the other parity tests
  run it); kernel 5's plain route (``TPINN_USE_PALLAS=1``) equal to the
  closed form;
* the dry run's case (``build_spec`` / ``default_options``) equal to the
  JAX package's ``_poiseuille_spec`` and its path 3 options;
* ``dryrun_multichip(3, device="cpu")`` end to end: three gloo ranks,
  paths 2-4 within their bars, the JAX package's three lines.

Paths 2-4 against the JAX package's unsharded driver at 3 and 8 ranks are
jobs of tests/test_torch_driver_sharded.py's fixtures.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tpinn_torch import entry

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as graft  # noqa: E402

torch.set_num_threads(1)

F32_BAR, F64_BAR = 1e-5, 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One host BLAS thread (the dry run's LM references here), as one
    torch thread; the spawned ranks take one each."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _torch_params(params, dtype):
    return [{k: torch.as_tensor(np.array(p[k]), dtype=dtype)
             for k in ("kernel", "bias")} for p in params]


@pytest.fixture(scope="module")
def tpinn_entry():
    fn, (params, x) = graft.entry()
    return jax.jit(fn), params, x


def test_entry_draw_is_tpinns(tpinn_entry):
    _, _, x = tpinn_entry
    _, (_, got) = entry.entry("cpu")
    assert got.dtype == torch.float32 and got.shape == (4096, 2)
    assert got.numpy().tobytes() == np.asarray(x).tobytes()
    _, (_, got64) = entry.entry("cpu", torch.float64)
    np.testing.assert_array_equal(
        got64.numpy(), np.random.default_rng(0).uniform(0, 1, (4096, 2)))


def test_entry_equals_tpinn_float32(tpinn_entry):
    jfn, params, x = tpinn_entry
    want = float(jfn(params, x))
    fn, (_, tx) = entry.entry("cpu")
    with torch.no_grad():
        got = float(fn(_torch_params(params, torch.float32), tx))
    assert abs(got / want - 1.0) < F32_BAR


def test_entry_equals_tpinn_float64(tpinn_entry):
    jfn, params, _ = tpinn_entry
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                 params)
    fn, (_, tx) = entry.entry("cpu", torch.float64)
    want = float(jfn(p64, jnp.asarray(tx.numpy())))
    with torch.no_grad():
        got = float(fn(_torch_params(p64, torch.float64), tx))
    assert abs(got / want - 1.0) < F64_BAR


def test_kernel5_route_equals_closed_form(monkeypatch):
    for dtype in (torch.float32, torch.float64):
        fn, (params, x) = entry.entry("cpu", dtype)
        with torch.no_grad():
            closed = fn(params, x)
            monkeypatch.setenv("TPINN_USE_PALLAS", "1")
            routed = fn(params, x)
            monkeypatch.delenv("TPINN_USE_PALLAS")
        assert torch.equal(routed, closed), dtype


def test_dryrun_case_is_tpinns():
    ref, got = graft._poiseuille_spec(), entry.build_spec()
    for f in ("name", "grid_shape", "weights", "neumann", "width", "depth"):
        assert getattr(got, f) == getattr(ref, f), f
    assert [tuple(e) for e in got.extents] == [tuple(e) for e in ref.extents]
    assert (got.physics.conv, got.physics.visc) == (ref.physics.conv,
                                                    ref.physics.visc)
    x = np.random.default_rng(1).uniform(0, 0.1, (50, 2))
    for a, b in zip(got.exact, ref.exact):
        np.testing.assert_allclose(np.asarray(a(torch.as_tensor(x))),
                                   np.asarray(b(jnp.asarray(x))),
                                   rtol=1e-15, atol=0)
    for comp in (0, 1):
        assert got.bnd_val[comp].keys() == ref.bnd_val[comp].keys()
    opts = entry.default_options()
    assert (opts.epochs, opts.n_pde, opts.n_bc, opts.n_vel, opts.n_pres,
            opts.n_test) == (15, 64, 10, 5, 0, 30)


@pytest.fixture(scope="module")
def dryrun():
    """``dryrun_multichip(3, device="cpu")`` once (three spawned ranks) and
    the lines it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = entry.dryrun_multichip(3, device="cpu")
    return out, buf.getvalue().splitlines()


def test_dryrun_multichip_prints_tpinns_lines(dryrun):
    out, printed = dryrun
    lines = [l for l in printed if l.startswith("dryrun_multichip")]
    assert lines == out["lines"] and len(lines) == 3
    assert lines[0].startswith("dryrun_multichip: mesh {'points': 3}, "
                               "batch (192, 2), loss ")
    assert "(187 true rows, exact-mean masked" in lines[0]
    assert "training-deep: rounds ['keras_Adam', 'jax_L-BFGS']" in lines[1]
    assert "second-order: rounds ['keras_Adam', 'jax_LM']" in lines[2]
    assert out["backend"] == "gloo" and out["rank_device"] == "cpu"


def test_dryrun_multichip_holds_its_bars(dryrun):
    out, _ = dryrun
    assert [s["dtype"] for s in out["steps"]] == ["torch.float32",
                                                  "torch.float64"]
    for step in out["steps"]:
        assert entry.step_ok(step)
    assert out["paths"][4]["fast_gram"] == [True] * 3
    for path in (3, 4):
        assert out["paths"][path]["devs"][1] < entry.ADAM_BAR
        assert out["paths"][path]["devs"][2] < entry.ROUND_BAR
