"""The port's cavity oracle (tpinn_torch/oracles/cavity.py) against the JAX
package's, in float64 on the CPU.

tpinn's pressure solve calls ``jax.scipy.sparse.linalg.cg``, which does not
report its iterations; the tests count them with a copy of jax's loop that
records its count through ``jax.debug.callback``, after checking that the
copy gives jax's iterate.  The bars: every field within 1e-10·max|field|
(measured 1.5e-15 at n = 16 over five steps) and the same iteration count
in every pressure solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpinn.oracles import cavity as jc
from tpinn.oracles import generate as jgen
from tpinn.oracles import io as jio
from tpinn_torch.oracles import cavity as tc
from tpinn_torch.oracles import generate as tgen
from tpinn_torch.oracles import io as tio

torch.set_num_threads(1)

FIELD_BAR = 1e-10


def _counting_cg(counts):
    """jax's conjugate gradients (jax/_src/scipy/sparse/linalg.py,
    ``_cg_solve``, no preconditioner) recording each solve's iterations."""

    def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
        atol2 = jnp.maximum(jnp.square(tol) * jnp.vdot(b, b),
                            jnp.square(atol))

        def cond(v):
            return (v[2] > atol2) & (v[4] < maxiter)

        def body(v):
            x, r, gamma, p, k = v
            ap = A(p)
            alpha = gamma / jnp.vdot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            gamma_ = jnp.vdot(r, r)
            return x, r, gamma_, r + (gamma_ / gamma) * p, k + 1

        r0 = b - A(x0)
        x, _, _, _, k = lax.while_loop(cond, body,
                                       (x0, r0, jnp.vdot(r0, r0), r0, 0))
        jax.debug.callback(lambda k: counts.append(int(k)), k, ordered=True)
        return x, None

    return cg


@pytest.fixture
def counted(monkeypatch):
    """Patch tpinn's CG with the counting copy; the recorded counts."""
    counts = []
    monkeypatch.setattr(jax.scipy.sparse.linalg, "cg", _counting_cg(counts))
    jax.clear_caches()
    yield counts
    jax.clear_caches()


def test_counting_copy_gives_jax_iterate():
    rng = np.random.default_rng(0)
    b = rng.normal(size=(16, 16))
    b = jnp.asarray(b - b.mean())
    x0 = jnp.asarray(rng.normal(size=(16, 16)) * 1e-2)
    op = lambda q: jc._poisson_neumann_op(q, 1 / 16)
    ref, _ = jax.scipy.sparse.linalg.cg(op, b, x0=x0, tol=1e-8, maxiter=600)
    counts = []
    got, _ = _counting_cg(counts)(op, b, x0, tol=1e-8, maxiter=600)
    jax.effects_barrier()
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=1e-12 * float(jnp.max(jnp.abs(ref))))
    assert counts and 0 < counts[0] < 600


def test_cg_matches_tpinn_from_a_cold_start():
    """The port's CG on tpinn's operator against jax's, with the count."""
    rng = np.random.default_rng(1)
    b = rng.normal(size=(20, 20))
    b -= b.mean()
    op_j = lambda q: jc._poisson_neumann_op(q, 1 / 20)
    ref, _ = jax.scipy.sparse.linalg.cg(op_j, jnp.asarray(b),
                                        x0=jnp.zeros_like(b), tol=1e-8,
                                        maxiter=600)
    jcounts = []
    _counting_cg(jcounts)(op_j, jnp.asarray(b), jnp.zeros_like(b), tol=1e-8,
                          maxiter=600)
    jax.effects_barrier()
    counts = tc.CGCounts()
    got = tc.cg(lambda q: tc._poisson_neumann_op(q, 1 / 20),
                torch.as_tensor(b), torch.zeros(20, 20, dtype=torch.float64),
                counts=counts)
    scale = float(np.max(np.abs(np.asarray(ref))))
    assert float(np.max(np.abs(got.numpy() - np.asarray(ref)))) <= 1e-12 * scale
    assert counts.iterations() == jcounts
    # the flag is read once per CG_CHECK iterations, plus the first test
    assert counts.syncs == 1 + jcounts[0] // tc.CG_CHECK + 1


def _assert_fields_close(ref_snaps, snaps):
    assert len(ref_snaps) == len(snaps)
    for ref, got in zip(ref_snaps, snaps):
        for a, b in zip(ref, got):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape
            scale = max(float(np.max(np.abs(a))), 1e-300)
            assert float(np.max(np.abs(a - b))) <= FIELD_BAR * scale


@pytest.mark.parametrize("n,t_end,substeps", [(16, 5e-4, None), (12, 3e-4, 2)])
def test_unsteady_matches_tpinn(counted, n, t_end, substeps):
    times, snaps = jc.solve_cavity_unsteady(n=n, t_end=t_end, dt_out=1e-4,
                                            substeps=substeps)
    jax.effects_barrier()
    counts = tc.CGCounts()
    t_times, t_snaps = tc.solve_cavity_unsteady(n=n, t_end=t_end,
                                                dt_out=1e-4,
                                                substeps=substeps,
                                                device="cpu", counts=counts)
    np.testing.assert_array_equal(t_times, times)
    _assert_fields_close(snaps, t_snaps)
    assert counts.iterations() == counted
    assert len(counted) == len(times) * (substeps or 1)
    # the t = 0 snapshot is the zero field; later ones move with the lid
    assert all(np.all(f == 0.0) for f in t_snaps[0])
    assert np.max(t_snaps[-1][0]) == 1.0


def test_steady_matches_tpinn(counted):
    ref = jc.solve_cavity_steady(re=100.0, n=16, t_end=2.0)
    jax.effects_barrier()
    counts = tc.CGCounts()
    got = tc.solve_cavity_steady(re=100.0, n=16, t_end=2.0, device="cpu",
                                 counts=counts)
    _assert_fields_close([ref], [got])
    its = counts.iterations()
    assert its == counted and len(its) == 100  # two blocks of 50 steps


def test_vertex_grid_and_interpolation_match_tpinn():
    for n in (4, 16, 100):
        for a, b in zip(tc.vertex_grid(n), jc.vertex_grid(n)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    n = 16
    field = rng.normal(size=(n + 1) ** 2)
    xq, yq = rng.uniform(-0.1, 1.1, 200), rng.uniform(-0.1, 1.1, 200)
    xq[:3], yq[:3] = (0.0, 1.0, 0.5), (1.0, 0.0, 0.5)
    np.testing.assert_array_equal(
        tc.interpolate_vertex_field(field, n, xq, yq),
        jc.interpolate_vertex_field(field, n, xq, yq))
    # at the vertices the interpolation gives the field back
    xs, ys = tc.vertex_grid(n)
    np.testing.assert_allclose(tc.interpolate_vertex_field(field, n, xs, ys),
                               field, rtol=0, atol=1e-13)


def test_series_files_round_trip(tmp_path, monkeypatch):
    """The port writes the per-step h5 series of the reference's layout
    (tpinn's reader reads it) and, without h5py, npz files of the same
    arrays; each step's pressure is recentred on reading, as tpinn's."""
    rng = np.random.default_rng(3)
    snaps = [tuple(rng.normal(size=25) for _ in range(3)) for _ in range(4)]
    folder = str(tmp_path / "h5")
    paths = tio.write_unsteady_series(folder, snaps)
    assert all(p.endswith(".h5") for p in paths)
    assert paths[1] == jio.unsteady_h5_path(folder, 1)
    ref = jio.read_unsteady_series_h5(folder, 4)
    got = tio.read_unsteady_series(folder, 4)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[2][:25].mean(), 0.0, atol=1e-15)
    monkeypatch.setattr(tio.utils, "has_module", lambda name: False)
    folder_npz = str(tmp_path / "npz")
    assert all(p.endswith(".npz")
               for p in tio.write_unsteady_series(folder_npz, snaps))
    for a, b in zip(ref, tio.read_unsteady_series(folder_npz, 4)):
        np.testing.assert_array_equal(a, b)


def test_generate_matches_tpinn(tmp_path, counted):
    """generate_cavity_unsteady writes the oracle's series once and reuses
    it; on a small grid the series equals tpinn's within the field bar."""
    kw = dict(U=1.0, nu=1.0, T=4e-4, dt=1e-4, n=12)
    jfolder = jgen.generate_cavity_unsteady(str(tmp_path / "j"), **kw)
    ref = jio.read_unsteady_series_h5(jfolder, 4)
    counts = tc.CGCounts()
    folder = tgen.generate_cavity_unsteady(str(tmp_path / "t"), device="cpu",
                                           counts=counts, **kw)
    got = tio.read_unsteady_series(folder, 4)
    for a, b in zip(ref, got):
        assert float(np.max(np.abs(a - b))) <= FIELD_BAR * float(
            np.max(np.abs(a)))
    assert counts.iterations() == counted
    again = tc.CGCounts()
    assert tgen.generate_cavity_unsteady(str(tmp_path / "t"), device="cpu",
                                         counts=again, **kw) == folder
    assert again.iterations() == []
