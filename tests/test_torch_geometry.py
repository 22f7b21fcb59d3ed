"""tpinn_torch.geometry against tpinn.geometry: grids, normalization and the
residual scale match exactly; the random samplers keep their contracts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn import geometry as jg
from tpinn.oracles import analytic as ja
from tpinn_torch import geometry as tg
from tpinn_torch.oracles import analytic as ta

torch.set_num_threads(1)


# the rectangle grids of the Poiseuille and cavity cases (examples/*)
@pytest.mark.parametrize("extents,shape", [
    ([(0.0, 1.0), (0.0, 0.1)], (100, 25)),
    ([(0.0, 1.0), (0.0, 1.0)], (100, 100)),
])
def test_rect_grid_matches_exactly(extents, shape):
    ref = np.asarray(jg.rect_grid(extents, shape))
    got = tg.rect_grid(extents, shape).numpy()
    assert got.shape == ref.shape == ((shape[0] + 1) * (shape[1] + 1), 2)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("extents,shape", [([(-1.0, 1.0), (-1.0, 1.0)], (100, 100)),
                                           ([(-1.0, 2.0), (0.5, 0.7)], (7, 3)),
                                           ([(0.1, 0.3), (-3.0, 7.0)], (12, 32))])
def test_rect_grid_other_extents_within_one_ulp(extents, shape):
    """XLA's linspace arithmetic is not one fixed formula (it depends on how
    the graph simplifies), so on other extents (the colliding-flow square
    among them) the grids agree to within one ulp."""
    ref = np.asarray(jg.rect_grid(extents, shape))
    got = tg.rect_grid(extents, shape).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=np.spacing(np.abs(ref).max()))


def test_tensor_grid_x_fastest():
    got = tg.tensor_grid(torch.tensor([0.0, 1.0, 2.0]), torch.tensor([5.0, 6.0]))
    ref = np.asarray(jg.tensor_grid(jnp.array([0.0, 1.0, 2.0]),
                                    jnp.array([5.0, 6.0])))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_poiseuille_normalization_and_scale_match_exactly():
    grid = np.asarray(jg.rect_grid([(0.0, 1.0), (0.0, 0.1)], (100, 25)))
    prm_j, prm_t = ja.PoiseuilleParams(), ta.PoiseuilleParams()
    jx, tx = jnp.asarray(grid), torch.as_tensor(grid)
    fields_j = [f(jx, prm_j) for f in (ja.poiseuille_u, ja.poiseuille_v,
                                       ja.poiseuille_p)]
    fields_t = [f(tx, prm_t) for f in (ta.poiseuille_u, ta.poiseuille_v,
                                       ta.poiseuille_p)]
    for a, b in zip(fields_t, fields_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    nj, nt = jg.Normalization(*fields_j), tg.Normalization(*fields_t)
    assert nt.norm_vel == nj.norm_vel
    assert nt.norm_pre == nj.norm_pre
    assert nt.residual_scale == nj.residual_scale


@pytest.mark.parametrize("vec", [[3.0, -1.0, 2.0], [0.0, 0.0]])
def test_spread_and_degenerate_normalization(vec):
    assert tg.spread(torch.tensor(vec)) == jg.spread(np.array(vec))
    nt = tg.Normalization(torch.zeros(3), torch.zeros(3), torch.tensor(vec))
    nj = jg.Normalization(np.zeros(3), np.zeros(3), np.array(vec))
    assert (nt.norm_vel, nt.norm_pre) == (nj.norm_vel, nj.norm_pre)


def test_split_indices_disjoint_and_sized():
    g = torch.Generator().manual_seed(0)
    counts = {"PDE": 50, "Vel": 5, "Pres": 0, "Test": 40}
    idx = tg.split_indices(g, 200, counts)
    assert {k: len(v) for k, v in idx.items()} == counts
    allidx = np.concatenate(list(idx.values()))
    assert len(np.unique(allidx)) == len(allidx)
    assert allidx.min() >= 0 and allidx.max() < 200
    # a generator seed reproduces the split
    again = tg.split_indices(torch.Generator().manual_seed(0), 200, counts)
    assert all(np.array_equal(idx[k], again[k]) for k in counts)


@pytest.mark.parametrize("horizon", [None, 2.0])
def test_rect_boundary_points_lie_on_edges(horizon):
    ext = [(0.0, 1.0), (0.0, 0.1)]
    pts = tg.rect_boundary_points(torch.Generator().manual_seed(1), ext, 64,
                                  time_horizon=horizon)
    ref = jg.rect_boundary_points(jax.random.PRNGKey(1), ext, 64,
                                  time_horizon=horizon)
    assert list(pts) == list(ref)
    off = 0 if horizon is None else 1
    for name, p in pts.items():
        assert p.shape == ref[name].shape
        x, y = p[:, off], p[:, off + 1]
        fixed = {"BOT": (y, 0.0), "TOP": (y, 0.1), "SX": (x, 0.0),
                 "DX": (x, 1.0)}[name]
        assert torch.all(fixed[0] == fixed[1])
        assert torch.all((x >= 0.0) & (x <= 1.0) & (y >= 0.0) & (y <= 0.1))
        if horizon is not None:
            assert torch.all((p[:, 0] >= 0.0) & (p[:, 0] <= horizon))


def test_generate_noise():
    g = torch.Generator().manual_seed(2)
    assert torch.all(tg.generate_noise(g, 10, 0.0) == 0.0)
    z = tg.generate_noise(torch.Generator().manual_seed(3), 20000, 0.5)
    assert abs(float(z.std()) - 0.5) < 0.02 and abs(float(z.mean())) < 0.02
    assert z.dtype == torch.float64
