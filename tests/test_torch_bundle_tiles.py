"""A model, in float64 torch, of how kernel 5 (csrc/taylor_bundle.cu)
decomposes its work, held against its plain version and against the JAX
package's Taylor-bundle kernel in interpret mode.

The model does what a kernel-5 block does, with explicit matrix products in
place of the tensor-core tiles: tiles of P points (the plan's P) whose
1 + 2·dim Taylor streams are stacked stream-major (row s·P + p, S·P rows, a
multiple of 8); widths padded to multiples of 8 with zero weights; a ragged
last tile whose missing points are zero; layer 0 in closed form; per later
layer Z = A·W and the tanh-Taylor epilogue; at the head the bias on the
value stream and the tile's outputs in output order, written as three
contiguous spans (value, jac, hdiag rows of the tile's points) of one
output buffer.  Bar: max |Δ| ≤ 1e-12·max|ref| per output (the kernel's
bar on the card).  Also here: the launch plan's mirror, and which nets it
takes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.pallas.mlp_bundle import mlp_taylor_bundle as jax_bundle
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.kernels import mlp_bundle as mb

torch.set_num_threads(1)

BAR = 1e-12


def _pad8(v):
    return (v + 7) // 8 * 8


def tile_model(params, x, dim, P):
    """(value, jac, hdiag) of the tanh MLP, computed tile by tile as a
    kernel-5 block does, into one output buffer."""
    widths = mb._widths(params)
    d, L, d_out = widths[0], len(widths) - 1, widths[-1]
    S = 1 + 2 * dim
    n = x.shape[0]
    wp = [d] + [_pad8(w) for w in widths[1:]]
    W, b = [], []
    for l, p in enumerate(params):
        Wl = torch.zeros(wp[l], wp[l + 1], dtype=torch.float64)
        Wl[:widths[l], :widths[l + 1]] = p["kernel"]
        bl = torch.zeros(wp[l + 1], dtype=torch.float64)
        bl[:widths[l + 1]] = p["bias"]
        W.append(Wl)
        b.append(bl)
    out = torch.full((n * d_out * S,), float("nan"), dtype=torch.float64)
    for t in range(-(-n // P)):
        n_act = min(P, n - t * P)
        xt = torch.zeros(P, d, dtype=torch.float64)
        xt[:n_act] = x[t * P:t * P + n_act]
        zv = xt @ W[0] + b[0]
        if L == 1:  # the head is layer 0
            sv = zv
            sj = [W[0][k].expand(P, -1) for k in range(dim)]
            sh = [torch.zeros(P, wp[1], dtype=torch.float64)] * dim
        else:
            v = torch.tanh(zv)
            tp = 1 - v * v
            a = -2 * v * tp
            A = torch.empty(S * P, wp[1], dtype=torch.float64)
            A[:P] = v
            for k in range(dim):
                zg = W[0][k]
                A[(1 + k) * P:(2 + k) * P] = tp * zg
                A[(1 + dim + k) * P:(2 + dim + k) * P] = a * zg * zg
            for l in range(1, L):
                Z = A @ W[l]  # every stream of the tile in one product
                rows = [Z[s * P:(s + 1) * P] for s in range(S)]
                if l + 1 == L:
                    sv, sj, sh = rows[0] + b[l], rows[1:1 + dim], rows[1 + dim:]
                    break
                v = torch.tanh(rows[0] + b[l])
                tp = 1 - v * v
                a = -2 * v * tp
                A = torch.empty(S * P, wp[l + 1], dtype=torch.float64)
                A[:P] = v
                for k in range(dim):
                    zg, zh = rows[1 + k], rows[1 + dim + k]
                    A[(1 + k) * P:(2 + k) * P] = tp * zg
                    A[(1 + dim + k) * P:(2 + dim + k) * P] = a * zg * zg + tp * zh
        # the stage in output order, then its three spans
        stage = torch.cat([sv[:, :d_out].reshape(-1),
                           torch.stack(sj, -1)[:, :d_out].reshape(-1),
                           torch.stack(sh, -1)[:, :d_out].reshape(-1)])
        pd, m = P * d_out, n_act * d_out
        v0 = t * pd
        out[v0:v0 + m] = stage[:m]
        j0, h0 = n * d_out + v0 * dim, n * d_out * (1 + dim) + v0 * dim
        out[j0:j0 + m * dim] = stage[pd:pd + m * dim]
        out[h0:h0 + m * dim] = stage[pd * (1 + dim):pd * (1 + dim) + m * dim]
    value, jac, hdiag = out.split([n * d_out, n * d_out * dim, n * d_out * dim])
    return (value.view(n, d_out), jac.view(n, d_out, dim),
            hdiag.view(n, d_out, dim))


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

NETS = {  # hidden widths, d_out
    "32-32-32-3": ((32, 32, 32), 3),
    "20-20-20-1": ((20, 20, 20), 1),
    "one-layer-3": ((), 3),
    "64-64-3": ((64, 64), 3),
}
DIMS = [(2, 1), (2, 2), (3, 1), (3, 2), (3, 3)]


def _problem(name, d_in, seed):
    hidden, d_out = NETS[name]
    widths = (d_in,) + hidden + (d_out,)
    rng = np.random.default_rng(seed)
    pnp = []
    for a, c in zip(widths[:-1], widths[1:]):
        lim = np.sqrt(6.0 / (a + c))
        pnp.append({"kernel": rng.uniform(-lim, lim, (a, c)),
                    "bias": rng.uniform(-0.1, 0.1, c)})
    P = mb.bundle_plan(widths, d_in, d_in, 8)[0]
    n = 2 * P + 5  # a ragged last tile
    x = rng.uniform(-1.0, 1.0, (n, d_in))
    return pnp, x, P


def _close(got, ref, what):
    for part, g, r in zip(("value", "jac", "hdiag"), got, ref):
        r = torch.as_tensor(np.array(r))
        assert tuple(g.shape) == tuple(r.shape), (what, part)
        err = float(torch.max(torch.abs(g - r)))
        assert err <= BAR * float(torch.max(torch.abs(r))), (what, part, err)


@pytest.mark.parametrize("d_in,dim", DIMS)
@pytest.mark.parametrize("name", list(NETS))
def test_tile_model_matches_plain(name, d_in, dim):
    """The plan's tile size, a ragged last tile, every dim of each d_in."""
    pnp, x, P = _problem(name, d_in, 3 + d_in + dim)
    params = params_from_numpy(pnp)
    xt = torch.as_tensor(x)
    _close(tile_model(params, xt, dim, P),
           mb.mlp_taylor_bundle_plain(params, xt, dim), (name, d_in, dim))


@pytest.mark.parametrize("P", [8, 16, 32])
def test_tile_model_every_tile_size(P):
    """Each candidate tile size on the main net, with a ragged last tile."""
    pnp, x, _ = _problem("32-32-32-3", 2, 11)
    params = params_from_numpy(pnp)
    xt = torch.as_tensor(x[:3 * P - 3])
    _close(tile_model(params, xt, 2, P),
           mb.mlp_taylor_bundle_plain(params, xt, 2), P)


@pytest.mark.parametrize("d_in", [2, 3])
@pytest.mark.parametrize("name", list(NETS))
def test_tile_model_matches_tpinn_interpret(name, d_in):
    """The model against the JAX package's Taylor-bundle kernel in
    interpret mode (its own 256-point tiles, the last one padded)."""
    pnp, x, P = _problem(name, d_in, 17 + d_in)
    dim = d_in - 1
    ref = jax_bundle([{k: jnp.asarray(v) for k, v in p.items()}
                      for p in pnp], jnp.asarray(x), dim=dim, np_tile=256,
                     interpret=True)
    got = tile_model(params_from_numpy(pnp), torch.as_tensor(x), dim, P)
    _close(got, ref, (name, d_in))


# ---------------------------------------------------------------------------
# the launch plan's mirror
# ---------------------------------------------------------------------------


def _old_bundle_elems(widths, d_in, dim, points):
    """Shared-memory elements of the one-warp-per-point layout that kernel 5
    had before the tile design: the weights with padded rows, then per
    point its input row and two stream buffers of S·max_width."""
    L = len(widths) - 1
    total = sum(widths[l] * (widths[l + 1] + 1) + widths[l + 1]
                for l in range(L))
    return total + points * (d_in + 2 * (1 + 2 * dim) * max(widths[1:]))


def test_plan_takes_every_net_the_old_layout_took():
    """Every net of 1-8 layers of uniform width 1-64 (head widths 1, 3 and
    the hidden width), d_in 2 and 3, dim 1..d_in, float32 and float64 that
    the old layout fitted in SMEM_LIMIT has a plan, within SMEM_LIMIT, of
    at least 8 points per tile."""
    for L in range(1, 9):
        for w in range(1, 65):
            for d_in in (2, 3):
                for dim in range(1, d_in + 1):
                    for d_out in sorted({1, 3, w}):
                        widths = (d_in,) + (w,) * (L - 1) + (d_out,)
                        for item in (4, 8):
                            old = (_old_bundle_elems(widths, d_in, dim, 1)
                                   * item <= mb.SMEM_LIMIT)
                            P, streamed, nbytes = mb.bundle_plan(
                                widths, d_in, dim, item)
                            assert P >= 8 or not old, (widths, dim, item)
                            assert nbytes <= mb.SMEM_LIMIT
                            assert nbytes == item * mb.bundle_layout(
                                widths, d_in, dim, P, streamed)["total"]


def test_plan_of_the_main_shapes():
    """2-32-32-32-3, dim 2: 16-point float64 tiles and 32-point float32
    tiles, each block small enough for two per SM; the 8-layer width-64
    net streams its weights."""
    main = (2, 32, 32, 32, 3)
    assert mb.bundle_plan(main, 2, 2, 8) == (16, False, 69504)
    assert mb.bundle_plan(main, 2, 2, 4) == (32, False, 58048)
    for item in (4, 8):
        assert mb.bundle_plan(main, 2, 2, item)[2] <= mb.TWO_BLOCK_SMEM
    P, streamed, nbytes = mb.bundle_plan((3,) + (64,) * 7 + (3,), 3, 3, 8)
    assert streamed and P >= 8 and nbytes <= mb.SMEM_LIMIT


def test_layout_regions():
    """The layout's total is its regions: resident or streamed weights, the
    biases, two input buffers and two stream buffers."""
    ly = mb.bundle_layout((2, 32, 32, 32, 3), 2, 2, 16, False)
    assert ly["wp"] == [2, 32, 32, 32, 8] and ly["ld"] == [2, 36, 36, 36, 12]
    weights = 2 * 36 + 32 * 36 + 32 * 36 + 32 * 12
    assert ly["total"] == weights + (32 * 3 + 8) + 2 * 32 + 2 * 5 * 16 * 36
    st = mb.bundle_layout((3,) + (64,) * 7 + (3,), 3, 3, 16, True)
    assert st["slot"] == 64 * 68
    assert st["total"] == (3 * 68 + 7 * 64 + 8 + 2 * 64 * 68 + 2 * 48
                           + 2 * 7 * 16 * 68)
