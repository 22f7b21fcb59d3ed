"""The port's point-axis sharding (tpinn_torch/sharding.py) against the JAX
package's, on gloo ranks spawned on the CPU.

* ``pad_to_multiple``, ``shard_points`` and ``shard_pair`` equal tpinn's bit
  for bit, padded rows and mask-scale rows included: tpinn on the root
  conftest's 8-device CPU mesh, the port on 8 ranks, its shards
  concatenated in rank order;
* ``_local_valid_count`` equals tpinn's (evaluated per shard under
  ``shard_map``) on every rank;
* ``sharded_ns_residual_mse`` and ``sharded_ns_weighted_obj`` (the plain
  twins on the CPU) at 3 and 8 ranks, on a 70-row and a 507-row batch and a
  10-row batch that leaves three of eight shards all padding, equal the
  unsharded port: loss / MSEs at rtol 1e-12, dW/db at rtol 1e-9 / atol
  1e-12 (tests/test_pallas.py's bars), the same bits on every rank;
* a rank that raises fails the run within its limit instead of hanging the
  others.

The ranks run ``tpinn_torch.sharded_runs.run_jobs``, which imports no JAX:
the parent makes tpinn's inputs and passes them on as numpy arrays.
"""

import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpinn import sharding as jsh
from tpinn_torch import sharded_runs, sharding
from tpinn_torch.geometry import Normalization
from tpinn_torch.kernels import mlp_bundle as mb
from tpinn_torch.pipeline import NSPhysics

torch.set_num_threads(1)

LOSS_RTOL = 1e-12
GRAD_RTOL, GRAD_ATOL = 1e-9, 1e-12
WIDTHS = (2, 16, 16, 3)
PHYSICS = dict(conv=3.1, visc=0.89)
WEIGHTS = (10.0, 1.0, 1.0)
COTANGENT = (0.3, 1.7, -0.4)
BATCHES = {"70": 70, "507": 507, "10": 10}
# spawned ranks: collectives time out after TIMEOUT s, a run after DEADLINE
TIMEOUT, DEADLINE = 30.0, 100.0


def _params(rng):
    out = []
    for a, b in zip(WIDTHS[:-1], WIDTHS[1:]):
        lim = np.sqrt(6.0 / (a + b))
        out.append({"kernel": rng.uniform(-lim, lim, (a, b)),
                    "bias": rng.uniform(-0.1, 0.1, b)})
    return out


def _norm():
    return Normalization(np.array([0.0, 2.0]), np.array([0.0, 1.0]),
                         np.array([-3.0, 3.0]))


def _inputs():
    rng = np.random.default_rng(15)
    points = {"13": rng.normal(size=(13, 2)), "64": rng.normal(size=(64, 2)),
              "507": rng.uniform(size=(507, 2))}
    pairs = {name: (x, [rng.normal(size=x.shape[0]), 0.5])
             for name, x in points.items()}
    batches = {name: (rng.uniform(size=(n, 2)), n)
               for name, n in BATCHES.items()}
    return points, pairs, batches, _params(rng)


def _spawn(nprocs, jobs, tmp_path):
    sharding.spawn(sharded_runs.run_jobs, nprocs, args=(jobs, str(tmp_path)),
                   timeout=TIMEOUT, deadline=DEADLINE)
    return sharded_runs.load(str(tmp_path), nprocs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One objectives job on 8 ranks and one on 3, by rank."""
    points, pairs, batches, params = _inputs()
    job = {"kind": "objectives", "points": points, "pairs": pairs,
           "batches": batches, "params": params, "physics": PHYSICS,
           "norm": _norm(), "weights": WEIGHTS, "cotangent": COTANGENT}
    return {w: [r[0] for r in _spawn(w, [job], tmp_path_factory.mktemp(
        f"w{w}"))] for w in (8, 3)}


def test_pad_shard_points_and_pair_equal_tpinn(runs):
    assert len(jax.devices()) == 8
    mesh = jsh.point_mesh()
    points, pairs, _, _ = _inputs()
    ranks = runs[8]
    for name, arr in points.items():
        ref_pad, n = jsh.pad_to_multiple(arr, 8)
        got_pad, n_got = sharding.pad_to_multiple(arr, 8)
        assert n == n_got == arr.shape[0]
        np.testing.assert_array_equal(got_pad.numpy(), np.asarray(ref_pad))
        np.testing.assert_array_equal(ranks[3][f"pad {name}"],
                                      np.asarray(ref_pad))
        ref = np.asarray(jsh.shard_points(arr, mesh))
        got = np.concatenate([r[f"points {name}"] for r in ranks])
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    for name, (x, rhs) in pairs.items():
        xs, (rs, r0), scale = jsh.shard_pair(x, rhs, mesh)
        got_x = np.concatenate([r[f"pair {name}"][0] for r in ranks])
        got_r = np.concatenate([r[f"pair {name}"][1][0] for r in ranks])
        np.testing.assert_array_equal(got_x, np.asarray(xs))
        np.testing.assert_array_equal(got_r, np.asarray(rs))
        assert all(r[f"pair {name}"][1][1] == r0 == 0.5 for r in ranks)
        if scale is None:
            assert all(r[f"pair {name}"][2] is None for r in ranks)
            assert x.shape[0] % 8 == 0
        else:
            got_s = np.concatenate([r[f"pair {name}"][2] for r in ranks])
            np.testing.assert_array_equal(got_s, np.asarray(scale))
            # the mean over the padded batch is the original mean
            r_pad = (got_x[:, 0] - got_r) * got_s
            np.testing.assert_allclose(np.mean(r_pad ** 2),
                                       np.mean((x[:, 0] - rhs[0]) ** 2),
                                       rtol=1e-14)


@pytest.mark.parametrize("n_true", [70, 507, 10, 64])
def test_local_valid_count_equals_tpinn(n_true):
    mesh = jsh.point_mesh()
    per = -(-n_true // 8)
    x = jax.device_put(np.zeros((8 * per, 1)), jsh.point_sharding(mesh))
    ref = jax.shard_map(
        lambda xl: jsh._local_valid_count(n_true, per)[None] + 0 * xl[:1, 0],
        mesh=mesh, in_specs=(P("points"),), out_specs=P("points"),
        check_vma=False)(x)
    got = [sharding._local_valid_count(n_true, per, r) for r in range(8)]
    assert got == [int(v) for v in np.asarray(ref)]
    assert sum(got) == n_true


def _reference(x, params):
    """The unsharded port on the whole batch: (loss, mses, dW/db of the
    loss, the MSEs again through ns_residual_mse, dW/db of mses·c)."""
    p = [{k: torch.tensor(v[k], requires_grad=True)
          for k in ("kernel", "bias")} for v in params]
    flat = [t for q in p for t in (q["kernel"], q["bias"])]
    xt = torch.as_tensor(x)
    loss, mses = mb.ns_residual_weighted_obj(p, xt, NSPhysics(**PHYSICS),
                                             _norm(), WEIGHTS)
    g = torch.autograd.grad(loss, flat)
    m = mb.ns_residual_mse(p, xt, NSPhysics(**PHYSICS), _norm())
    gm = torch.autograd.grad(
        torch.dot(m, torch.tensor(COTANGENT, dtype=m.dtype)), flat)
    return (loss.detach().numpy(), mses.numpy(), [t.numpy() for t in g],
            m.detach().numpy(), [t.numpy() for t in gm])


@pytest.mark.parametrize("world", [3, 8])
@pytest.mark.parametrize("batch", list(BATCHES))
def test_sharded_objectives_equal_unsharded(runs, world, batch):
    _, _, batches, params = _inputs()
    x, n_true = batches[batch]
    loss, mses, grads, m, gm = _reference(x, params)
    ranks = [r[f"batch {batch}"] for r in runs[world]]
    per = -(-n_true // world)
    assert [r["n_valid"] for r in ranks] == [
        min(max(n_true - i * per, 0), per) for i in range(world)]
    assert all(r["n_mean"] == n_true for r in ranks)
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["mses"], mses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["mse"], m, rtol=LOSS_RTOL)
    for a, b in zip(got["grads"] + got["mse_grads"], grads + gm):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the global result, the same bits, on every rank
    for r in ranks[1:]:
        for key in ("loss", "mses", "mse"):
            np.testing.assert_array_equal(r[key], got[key])
        for a, b in zip(r["grads"] + r["mse_grads"],
                        got["grads"] + got["mse_grads"]):
            np.testing.assert_array_equal(a, b)


def test_all_padding_shards_add_zero(runs):
    """10 rows on 8 ranks: shards 5-7 hold padding alone and add nothing."""
    ranks = [r["batch 10"] for r in runs[8]]
    assert [r["n_valid"] for r in ranks] == [2, 2, 2, 2, 2, 0, 0, 0]
    assert all(np.isfinite(r["loss"]) and np.all(np.isfinite(r["mses"]))
               for r in ranks)


def test_kernel_wrapper_sums_nothing_without_valid_rows():
    """Rows at and beyond n_valid = 0 are skipped: zero sums and gradients
    (the plain version here; tests/test_torch_cuda.py holds the kernel)."""
    _, _, batches, params = _inputs()
    x = torch.as_tensor(batches["70"][0])
    p = [{k: torch.tensor(v[k], requires_grad=True)
          for k in ("kernel", "bias")} for v in params]
    loss, mses = mb.ns_residual_weighted_obj(
        p, x, NSPhysics(**PHYSICS), _norm(), WEIGHTS, n_valid=0, n_mean=70)
    g = torch.autograd.grad(loss, [t for q in p for t in q.values()],
                            allow_unused=True, materialize_grads=True)
    assert float(loss.detach()) == 0.0 and not mses.any()
    assert all(not t.any() for t in g)


def test_a_raising_rank_fails_the_run_in_time(tmp_path):
    """Rank 1 raises before the job while the others enter its
    collectives: the spawn raises well within the collectives' timeout and
    the deadline, with rank 1's error or a waiting rank's report of the
    lost connection, whichever the parent sees first, and stops the other
    ranks."""
    _, _, batches, params = _inputs()
    job = {"kind": "objectives", "batches": {"70": batches["70"]},
           "params": params, "physics": PHYSICS, "norm": _norm(),
           "weights": WEIGHTS, "cotangent": COTANGENT, "fail_rank": 1}
    t0 = time.perf_counter()
    # gloo words the waiting ranks' error "Connection closed by peer" or
    # "Connection reset by peer", each "... remote worker ..."
    with pytest.raises(Exception, match="rank 1 fails|remote worker"):
        _spawn(3, [job], tmp_path)
    assert time.perf_counter() - t0 < DEADLINE


def test_import_initializes_no_process_group():
    import torch.distributed as dist

    import tpinn_torch  # noqa: F401

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        sharding.point_mesh(devices="cpu")
