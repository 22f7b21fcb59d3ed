"""The port's counterpart of the JAX package's coronary diagnostic scripts
(tpinn_torch/diagnostics.py ← scripts/diag_coronary_floor.py and
scripts/diag_lm_mu_scan.py):

* at the JAX example's θ0 and draws (small options: 100 PDE and 100 test
  points, the 2-32-32-32-3 net) the loss, ‖grad‖, the eigenvalues of JᵀJ
  and df_pred at every μ of the ladder equal the same quantities computed
  by the JAX package at 1e-10 (float64);
* the CLI (``floor``, ``mu-scan``) on a resumed coronary run folder reads
  the folder's state: its loss is the history's last.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tests.test_torch_coronary_case import _base_dir as coronary_base
from tests.test_torch_coronary_case import _jax_arrays, _jax_example
from tests.test_torch_coronary_case import _port_problem
from tpinn_torch import diagnostics

torch.set_num_threads(1)

DIAG_BAR = 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One host BLAS thread (the eigh of JᵀJ), as one torch thread."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def coronary(tmp_path_factory):
    """The JAX example's problem at θ0 (captured at its first minimize) and
    the port's on the same draws, small options."""
    base = coronary_base(tmp_path_factory.mktemp("coronary"), n_pde=100,
                         n_test=100)
    arrays, params, _ = _jax_arrays(base)
    jex = _jax_example()
    captured = {}

    class Captured(Exception):
        pass

    def capture(pb, *a, **k):
        captured["pb"] = pb
        raise Captured

    jex.ns.minimize = capture
    with contextlib.suppress(Captured):
        jex.main(epochs=1, second_round="scipy", seed=0, base_dir=base)
    tpb, _ = _port_problem(arrays, params)
    return captured["pb"], tpb, base


def _tpinn_floor_and_scan(pb):
    """The scripts' quantities by the JAX package's means."""
    from jax.flatten_util import ravel_pytree
    from tpinn.optimize import _flat_residual_fn

    theta0, unravel = ravel_pytree(pb.variables.get())
    val, grad = jax.value_and_grad(lambda th: pb.loss_fn(unravel(th)))(theta0)
    theta0, _, residuals = _flat_residual_fn(pb)
    n_par = theta0.shape[0]
    jac = jax.jit(lambda th, vs: jax.vmap(
        lambda v: jax.jvp(residuals, (th,), (v,))[1])(vs))
    eye = np.eye(n_par)
    Jt = jnp.concatenate([jac(theta0, jnp.asarray(eye[i:i + 256]))
                          for i in range(0, n_par, 256)])
    t64 = np.asarray(theta0, np.float64)
    hi = t64.astype(np.float32)
    lo = (t64 - hi.astype(np.float64)).astype(np.float32)
    r0, d0 = jax.jvp(residuals, (jnp.asarray(hi, jnp.float64),),
                     (jnp.asarray(lo, jnp.float64),))
    JTJ = np.asarray(Jt @ Jt.T, np.float64)
    JTr = np.asarray(Jt @ r0, np.float64) + np.asarray(Jt @ d0, np.float64)
    w, V = np.linalg.eigh(JTJ)
    w = np.maximum(w, 0.0)
    c = V.T @ JTr
    df_pred = []
    for mu in diagnostics.MUS:
        s = -(c / (w + mu * w[-1] + np.finfo(np.float64).tiny))
        df_pred.append(float(2.0 * c @ s + s @ (w * s)))
    return {"loss": float(val), "grad_norm": float(jnp.linalg.norm(grad)),
            "eigenvalues": w, "df_pred": df_pred}


def test_diagnostics_equal_tpinns(coronary):
    jpb, tpb, _ = coronary
    want = _tpinn_floor_and_scan(jpb)
    fl = diagnostics.floor(tpb, verbose=False)
    scan = diagnostics.mu_scan(tpb, verbose=False)
    assert fl["dtype"] == "torch.float64"
    assert abs(fl["loss"] / want["loss"] - 1.0) < DIAG_BAR
    assert abs(fl["grad_norm"] / want["grad_norm"] - 1.0) < DIAG_BAR
    w = scan["eigenvalues"]
    assert np.max(np.abs(w - want["eigenvalues"])) < DIAG_BAR * w[-1]
    got = [r["df_pred"] for r in scan["rows"]]
    for a, b in zip(got, want["df_pred"]):
        assert abs(a - b) <= DIAG_BAR * abs(b)
    assert [r["mu"] for r in scan["rows"]] == diagnostics.MUS
    # the probe and the eval at the same θ as the loss
    assert fl["probe"][1e-6] < fl["loss"]
    assert abs(sum(fl["train"].values()) / fl["loss"] - 1.0) < 1.0


def test_diagnostics_cli_reads_a_resumed_folder(coronary, capsys):
    from tpinn_torch.cases import coronary_flow_steady as cfs

    _, _, base = coronary
    before = set(os.listdir(base))
    pb, _ = cfs.main(2, base_dir=base, second_round="jax-bfgs", device="cpu")
    (name,) = set(os.listdir(base)) - before
    folder = os.path.join(base, name)
    assert diagnostics.main(["floor", "--folder", folder, "--device",
                             "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"loss = {pb.history.loss_global[-1]:.8e}" in out
    assert "step 1e-06 along -grad" in out and "test losses:" in out
    assert diagnostics.main(["mu-scan", "--folder", folder, "--device",
                             "cpu"]) == 0
    rows = [l.split() for l in capsys.readouterr().out.splitlines()]
    mus = [float(r[0]) for r in rows
           if len(r) == 6 and r[0].replace("e+", "").replace("e-", "")
           .isdigit()]
    assert mus == diagnostics.MUS


def test_diagnostics_of_a_float32_folder(coronary):
    """A float32 run folder is diagnosed in float32 (its checkpoint's
    dtype, the global dtype put back): its loss is the history's last to
    float32 rounding, and the split (hi, lo) linearization resolves the
    damped steps too small to change any float32 parameter, where the
    model's prediction and the split's change agree."""
    from tpinn_torch import config
    from tpinn_torch.cases import coronary_flow_steady as cfs

    _, _, base = coronary
    before = set(os.listdir(base))
    prev = config.get_dtype()
    config.set_dtype(torch.float32)
    try:
        pb, _ = cfs.main(2, base_dir=base, second_round="jax-bfgs",
                         device="cpu")
    finally:
        config.set_dtype(prev)
    (name,) = set(os.listdir(base)) - before
    rpb = diagnostics.resumed_problem(os.path.join(base, name),
                                      device="cpu")
    assert config.get_dtype() == prev
    fl = diagnostics.floor(rpb, verbose=False)
    scan = diagnostics.mu_scan(rpb, verbose=False)
    assert fl["dtype"] == scan["dtype"] == "torch.float32"
    assert abs(fl["loss"] / pb.history.loss_global[-1] - 1.0) < 1e-6
    rows = scan["rows"]
    assert np.isfinite([[r["df_split"], r["df_pred"]] for r in rows]).all()
    # steps that change (nearly) every float32 parameter, inside the
    # quadratic model's reach
    for r in rows:
        if 1e-1 <= r["mu"] <= 1e1:
            assert abs(r["ratio"] - 1.0) < 1e-2, r
    # steps below float32's resolution of θ: only the split's lo sees them
    unseen = [r for r in rows if r["hi_chg"] == 0]
    assert len(unseen) >= 3
    for r in unseen:
        assert abs(r["ratio"] - 1.0) < 5e-2, r
