"""A model, in float64 torch, of how the fused residual kernels (csrc/
taylor_mlp.cuh, kernels 1-4) decompose their work, held against the plain
versions and against the JAX package's Pallas kernels in interpret mode.

The model does what a kernel block does, with explicit matrix products in
place of the tensor-core tiles: tiles of P points whose Taylor streams are
stacked stream-major (row s·P + p) and padded to 8-row multiples; widths
padded to multiples of 8 with zero weights; a ragged last tile and rows at
and past n_valid zeroed; layer 0 in closed form; per later layer Z = A·W and
the tanh-Taylor epilogue; backward the cotangent rule, dW += Aᵀ·DZ and
dA = DZ·Wᵀ, skipping the head rows of streams that carry no cotangent when
a stream's rows are whole 8-row blocks.  Bars: loss and MSEs rtol 1e-12,
gradients rtol 1e-9 / atol 1e-12 (tests/test_pallas.py's).  Also here:
which shapes the tile layout fits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.geometry import Normalization as JaxNorm
from tpinn.pipeline import NSPhysics as JaxPhysics
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.geometry import Normalization
from tpinn_torch.kernels import mlp_bundle as mb
from tpinn_torch.pipeline import NSPhysics

torch.set_num_threads(1)

W3 = (10.0, 1.0, 1.0)
WEIGHT = 2.0
NH = 2


def _pad8(v):
    return (v + 7) // 8 * 8


class _NS:
    """The Navier–Stokes head: residual rows and head-stream cotangents."""

    n_sq, d_out, extra = 3, 3, False

    def __init__(self, d_in, physics, norm):
        nv, npre, scale, conv, visc, pres, tm = mb._phys_items(physics, norm)
        self.d = d_in
        self.off = 1 if d_in == 3 else 0
        self.cnv2, self.vnv, self.pn = conv * nv * nv, visc * nv, pres * npre
        self.tnv, self.scale = tm * nv, scale
        self.live = (0, 1 + d_in + NH)

    def rows(self, hd, xt):
        d, o = self.d, self.off
        val, gx, gy = hd[0], hd[1 + o], hd[2 + o]
        hx, hy = hd[1 + d], hd[2 + d]
        r = [gx[:, 0] + gy[:, 1]]
        for k in range(2):
            inner = (self.cnv2 * (val[:, 0] * gx[:, k] + val[:, 1] * gy[:, k])
                     - self.vnv * (hx[:, k] + hy[:, k])
                     + self.pn * (gx[:, 2] if k == 0 else gy[:, 2]))
            if d == 3:
                inner = inner + self.tnv * hd[1][:, k]
            r.append(inner * self.scale)
        return torch.stack(r, 1)

    def cotangents(self, hd, r, g, two_over_n):
        d, o = self.d, self.off
        c_m = g[0] * two_over_n * r[:, 0]
        c0 = g[1] * two_over_n * r[:, 1] * self.scale
        c1 = g[2] * two_over_n * r[:, 2] * self.scale
        val, gx, gy = hd[0], hd[1 + o], hd[2 + o]
        ds = torch.zeros_like(hd)
        z = torch.zeros_like(c0)
        ds[0] = torch.stack([c0 * self.cnv2 * gx[:, 0] + c1 * self.cnv2 * gx[:, 1],
                             c0 * self.cnv2 * gy[:, 0] + c1 * self.cnv2 * gy[:, 1],
                             z], 1)
        ds[1 + o] = torch.stack([c0 * self.cnv2 * val[:, 0] + c_m,
                                 c1 * self.cnv2 * val[:, 0], c0 * self.pn], 1)
        ds[2 + o] = torch.stack([c0 * self.cnv2 * val[:, 1],
                                 c1 * self.cnv2 * val[:, 1] + c_m,
                                 c1 * self.pn], 1)
        if d == 3:
            ds[1] = torch.stack([c0 * self.tnv, c1 * self.tnv, z], 1)
        dh = torch.stack([-c0 * self.vnv, -c1 * self.vnv, z], 1)
        ds[1 + d], ds[2 + d] = dh, dh
        return ds


class _Poisson:
    """The Poisson head: r = (u_xx + u_yy + f)·scale on the Hessian streams."""

    n_sq, d_out, extra = 1, 1, True

    def __init__(self, normalization):
        self.d, self.off = 2, 0
        self.scale = 1.0 / normalization
        self.live = (1 + 2, 1 + 2 + NH)

    def rows(self, hd, xt):
        return ((hd[3][:, 0] + hd[4][:, 0] + xt[:, 2]) * self.scale)[:, None]

    def cotangents(self, hd, r, g, two_over_n):
        ds = torch.zeros_like(hd)
        c = g[0] * two_over_n * r[:, 0] * self.scale
        ds[3][:, 0], ds[4][:, 0] = c, c
        return ds


def _stack(s, R):
    """(S, P, w) streams as the kernel's (R, w) matrix: row s·P + p, zero
    padding rows."""
    S, P, w = s.shape
    m = torch.zeros(R, w, dtype=s.dtype)
    m[:S * P] = s.reshape(S * P, w)
    return m


def _epilogue(z, d, off, first):
    """The tanh-Taylor epilogue: output streams and (tanh', z_g, z_h)."""
    v = torch.tanh(z[0])
    tp = 1 - v * v
    a = -2 * v * tp
    out = torch.empty_like(z)
    out[0] = v
    for k in range(d):
        out[1 + k] = tp * z[1 + k]
    for j in range(NH):
        h = a * (z[1 + j + off] * z[1 + j + off])
        out[1 + d + j] = h if first else h + tp * z[1 + d + j]
    aux = z.clone()
    aux[0] = tp
    return out, aux


def _cotangent_rule(ds, aux, v, d, off, first):
    """Cotangents of a hidden layer's pre-activation streams from those of
    its output streams (the kernel's elementwise backward rule)."""
    tp = aux[0]
    zg = [aux[1 + k] for k in range(d)]
    a = -2 * v * tp
    b2 = -2 * tp * (tp - 2 * v * v)
    dz = torch.empty_like(ds)
    dzv = ds[0] * tp
    for k in range(d):
        dzv = dzv + ds[1 + k] * (a * zg[k])
    for j in range(NH):
        hterm = b2 * (zg[j + off] * zg[j + off])
        if not first:
            hterm = hterm + a * aux[1 + d + j]
        dzv = dzv + ds[1 + d + j] * hterm
    dz[0] = dzv
    for k in range(d):
        g = ds[1 + k] * tp
        for j in range(NH):
            if j + off == k:
                g = g + ds[1 + d + j] * (2 * a * zg[k])
        dz[1 + k] = g
    for j in range(NH):
        dz[1 + d + j] = ds[1 + d + j] * tp
    return dz


def tile_model(params, x, head, gbar, P, n_valid=None, n_mean=None, f=None):
    """(loss, mses, flat gradients) of the fused residual objective with
    cotangents gbar, computed tile by tile as a kernel block does."""
    widths = mb._widths(params)
    d, L = widths[0], len(widths) - 1
    S = 1 + d + NH
    n = x.shape[0]
    n_eff = n if n_valid is None else n_valid
    n_mean = n if n_mean is None else n_mean
    wp = [d] + [_pad8(w) for w in widths[1:]]
    W, b = [], []
    for l, p in enumerate(params):
        Wl = torch.zeros(wp[l], wp[l + 1], dtype=torch.float64)
        Wl[:widths[l], :widths[l + 1]] = p["kernel"]
        bl = torch.zeros(wp[l + 1], dtype=torch.float64)
        bl[:widths[l + 1]] = p["bias"]
        W.append(Wl)
        b.append(bl)
    dW = [torch.zeros_like(w) for w in W]
    db = [torch.zeros_like(v) for v in b]
    sq = torch.zeros(head.n_sq, dtype=torch.float64)
    R = _pad8(S * P)
    skip = P % 8 == 0
    lo, hi = (head.live[0] * P, head.live[1] * P) if skip else (0, R)
    two_over_n = 2.0 / n_mean
    for t in range(-(-n_eff // P)):
        n_act = min(P, n_eff - t * P)
        xt = torch.zeros(P, d + (1 if head.extra else 0), dtype=torch.float64)
        xt[:n_act, :d] = x[t * P:t * P + n_act]
        if head.extra:
            xt[:n_act, d] = f[t * P:t * P + n_act]
        # layer 0 in closed form
        z = torch.zeros(S, P, wp[1], dtype=torch.float64)
        z[0] = xt[:, :d] @ W[0] + b[0]
        for k in range(d):
            z[1 + k] = W[0][k].expand(P, -1)
        acts, auxs = [], []
        if L == 1:
            hd = z
        else:
            a0, x0 = _epilogue(z, d, head.off, True)
            acts.append(a0)
            auxs.append(x0)
            for l in range(1, L):
                A = _stack(acts[l - 1], R)
                if l + 1 < L:
                    Z = (A @ W[l])[:S * P].reshape(S, P, wp[l + 1])
                    Z[0] = Z[0] + b[l]
                    al, xl = _epilogue(Z, d, head.off, False)
                    acts.append(al)
                    auxs.append(xl)
                else:  # the head: only the rows of live streams
                    Zm = torch.zeros(R, wp[L], dtype=torch.float64)
                    Zm[lo:hi] = A[lo:hi] @ W[l]
                    hd = Zm[:S * P].reshape(S, P, wp[L])
                    if head.live[0] == 0:
                        hd[0] = hd[0] + b[l]
        r = head.rows(hd[:, :, :head.d_out], xt)
        r[n_act:] = 0
        sq = sq + (r * r).sum(0)
        ds = torch.zeros(S, P, wp[L], dtype=torch.float64)
        ds[:, :n_act, :head.d_out] = head.cotangents(
            hd[:, :n_act, :head.d_out], r[:n_act], gbar, two_over_n)
        for l in range(L - 1, -1, -1):
            if l < L - 1:
                ds = _cotangent_rule(ds, auxs[l], acts[l][0], d, head.off,
                                     l == 0)
            DZ = _stack(ds, R)
            if l < L - 1 or head.live[0] == 0:
                db[l] += DZ[:P].sum(0)
            if l == 0:
                dW[0] += xt[:, :d].T @ ds[0] + torch.stack(
                    [ds[1 + i].sum(0) for i in range(d)])
                continue
            rl, rh = (lo, hi) if l == L - 1 else (0, R)
            A = _stack(acts[l - 1], R)
            dW[l] += A[rl:rh].T @ DZ[rl:rh]
            dA = torch.zeros(R, wp[l], dtype=torch.float64)
            dA[rl:rh] = DZ[rl:rh] @ W[l].T
            ds = dA[:S * P].reshape(S, P, wp[l])
    mses = sq / n_mean
    loss = (torch.as_tensor(gbar, dtype=torch.float64) * mses).sum()
    grads = torch.cat([t for l in range(L) for t in (
        dW[l][:widths[l], :widths[l + 1]].reshape(-1), db[l][:widths[l + 1]])])
    return loss, mses, grads


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

NORM = ([0.0, 2.0], [0.0, 1.0], [0.0, 5.0])
CASES = {
    "2-7-7-3": ((2, 7, 7, 3), "ns"),
    "2-20-20-20-1": ((2, 20, 20, 20, 1), "poisson"),
    "3-16-16-3": ((3, 16, 16, 3), "ns"),
}


def _params_np(widths, seed):
    rng = np.random.default_rng(seed)
    out = []
    for a, c in zip(widths[:-1], widths[1:]):
        lim = np.sqrt(6.0 / (a + c))
        out.append({"kernel": rng.uniform(-lim, lim, (a, c)),
                    "bias": rng.uniform(-0.1, 0.1, c)})
    return out


def _case(name, n, seed=3):
    widths, kind = CASES[name]
    pnp = _params_np(widths, seed)
    rng = np.random.default_rng(seed + 1)
    if kind == "ns":
        x = rng.uniform(0.0, 1.0, (n, widths[0]))
        coef = dict(conv=3.0, visc=0.5, time=1.0 if widths[0] == 3 else 0.0)
        return kind, pnp, x, None, coef
    x = rng.uniform(0.0, 2 * np.pi, (n, 2))
    f = 2.0 * np.sin(x[:, 0]) * np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    return kind, pnp, x, f, None


def _model(kind, pnp, x, f, coef, P, n_valid, n_mean):
    params = params_from_numpy(pnp)
    xt = torch.as_tensor(x)
    if kind == "ns":
        head = _NS(x.shape[1], NSPhysics(**coef),
                   Normalization(*(np.array(a) for a in NORM)))
        return tile_model(params, xt, head, W3, P, n_valid, n_mean)
    return tile_model(params, xt, _Poisson(1.5), (WEIGHT,), P, n_valid,
                      n_mean, torch.as_tensor(f))


def _plain(kind, pnp, x, f, coef, n_valid, n_mean):
    params = params_from_numpy(pnp)
    flat = [t.requires_grad_(True) for p in params
            for t in (p["kernel"], p["bias"])]
    if kind == "ns":
        loss, mses = mb.ns_residual_weighted_obj_plain(
            params, torch.as_tensor(x), NSPhysics(**coef),
            Normalization(*(np.array(a) for a in NORM)), W3, n_valid, n_mean)
    else:
        loss, mses = mb.poisson_residual_weighted_obj_plain(
            params, torch.as_tensor(x), torch.as_tensor(f), WEIGHT, 1.5,
            n_valid, n_mean)
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    return (loss.detach(), mses.reshape(-1),
            torch.cat([g.reshape(-1) for g in grads]))


def _close(got, ref):
    (l, m, g), (lr, mr, gr) = got, ref
    np.testing.assert_allclose(float(l), float(lr), rtol=1e-12)
    np.testing.assert_allclose(m.numpy(), np.asarray(mr).reshape(-1),
                               rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("P,n,n_valid", [(8, 45, 41), (3, 40, None),
                                         (16, 37, None)])
def test_tile_model_matches_plain(name, P, n, n_valid):
    """Tiles of 8 (dead head rows skipped), 3 (stream rows padded from 15
    to 16, nothing skipped) and 16 points; ragged last tiles and a masked
    tail; against the plain version (autograd)."""
    case = _case(name, n)
    n_mean = n_valid or n
    _close(_model(*case, P, n_valid, n_mean),
           _plain(*case, n_valid, n_mean))


def _pallas(kind, pnp, x, f, coef, n_valid, n_mean):
    from tpinn.pallas import ns_residual_weighted_obj as pallas_ns
    from tpinn.pallas import poisson_residual_weighted_obj as pallas_poisson

    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in pnp]
    xj = jnp.asarray(x)
    if kind == "ns":
        phys = JaxPhysics(**coef)
        norm = JaxNorm(*(np.array(a) for a in NORM))
        obj = lambda p: pallas_ns(p, xj, phys, norm, W3, np_tile=256,
                                  interpret=True, n_valid=n_valid,
                                  n_mean=n_mean)
    else:
        fj = jnp.asarray(f)
        obj = lambda p: pallas_poisson(p, xj, fj, WEIGHT, normalization=1.5,
                                       np_tile=256, interpret=True,
                                       n_valid=n_valid, n_mean=n_mean)
    loss, mses = obj(jp)
    g = jax.grad(lambda p: obj(p)[0])(jp)
    flat = np.concatenate([np.asarray(q[k]).reshape(-1) for q in g
                           for k in ("kernel", "bias")])
    return float(loss), np.asarray(mses), flat


@pytest.mark.parametrize("name", list(CASES))
def test_tile_model_matches_pallas_interpret(name):
    """The model against the JAX package's one-pass Pallas kernel (interpret
    mode on the CPU) with a masked tail, n = 300, n_valid = 250."""
    case = _case(name, 300, seed=5)
    _close(_model(*case, 8, 250, 250), _pallas(*case, 250, 250))


# ---------------------------------------------------------------------------
# launch-plan helpers
# ---------------------------------------------------------------------------


def _one_point_elems(widths, d_in, d_out, n_sq):
    """Shared-memory elements of the one-warp-per-point layout that the
    kernels had before the tile design (weights, accumulators, one point)."""
    S, L = 1 + d_in + NH, len(widths) - 1
    total = sum(widths[l] * (widths[l + 1] + 1) + widths[l + 1]
                for l in range(L))
    total += sum((widths[l] + 1) * widths[l + 1] for l in range(L)) + n_sq
    pt = d_in + sum(2 * S * widths[l + 1] for l in range(L - 1)) + S * d_out
    pt += S * max(widths[1:]) + n_sq
    return total + pt + (pt & 1)


def test_fits_keeps_every_shape_the_one_point_layout_took():
    """Every uniform-width net (1-8 layers, widths 1-64, both heads, d_in 2
    and 3, float32 and float64) that the one-point layout fitted in 227 KB
    still fits: a tile whose accumulators do not fit shared memory keeps
    them in its block's slice of the partials."""
    for L in range(1, 9):
        for w in range(1, 65):
            for d_in, d_out, n_sq in ((2, 3, 3), (3, 3, 3), (2, 1, 1)):
                widths = (d_in,) + (w,) * (L - 1) + (d_out,)
                for dtype in (torch.float32, torch.float64):
                    old = (_one_point_elems(widths, d_in, d_out, n_sq)
                           * mb.ITEMSIZE[dtype] <= mb.SMEM_LIMIT)
                    new = (mb.fits_poisson_kernel(widths, dtype) if d_out == 1
                           else mb.fits_kernel(widths, d_in, dtype))
                    assert new or not old, (widths, dtype)
