"""Differential operators: the per-point functional core on
``torch.func``, the closed-form batched Taylor propagation through a tanh
MLP, and the tape-style surface of nisaba's ``tens_style``.

The functional core (``gradient_fn``, ``jacobian_fn``, ``divergence_fn``,
``laplacian_fn``, ``hessian_diag_fn``, ``taylor_bundle`` and their batched
``v*`` forms) takes a per-point function ``f(xi)`` of any model.  PyTorch
has no Taylor-mode ``jet``; the second directional derivative
d²f(x + t·e_k)/dt² = e_kᵀ H e_k, the JAX package's jet ``d2`` along
(e_k, 0), is a jvp of a jvp along e_k, and the inner jvp's primal and
tangent give the value and the first derivative on the way.

The closed-form propagation is the plain PyTorch twin of the CUDA residual
kernels' stream math (tpinn_torch/kernels/csrc/taylor_mlp.cuh): for every
point it carries the value, one first-derivative stream per input column
and one Hessian-diagonal stream per input column through the layers,

    v' = tanh(z_v);  g'_k = tanh'(z_v) z_gk;
    h'_k = tanh''(z_v) z_gk² + tanh'(z_v) z_hk,

with the bias on the value stream only.

The tape-style operators (``gradient_scalar``, ``divergence_vector``,
``laplacian_scalar``, ``laplacian_vector``) take derivatives of tensors
computed from a batch watched by a :class:`tpinn_torch.tape.GradientTape`,
for any model, by reverse-mode autograd.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import func as tfunc

# ---------------------------------------------------------------------------
# Per-point functional core
# ---------------------------------------------------------------------------


def _scalarize(f: Callable) -> Callable:
    """f with its output reshaped to a true scalar ((1,) outputs)."""
    return lambda xi: f(xi).reshape(())


def _basis(xi: torch.Tensor) -> torch.Tensor:
    return torch.eye(xi.shape[-1], dtype=xi.dtype, device=xi.device)


def _jet2(f: Callable, xi: torch.Tensor, e: torch.Tensor):
    """(f(xi), df·e, eᵀ d²f e) along the direction e: a jvp of a jvp."""
    inner = lambda x: tfunc.jvp(f, (x,), (e,))
    (value, d1), (_, d2) = tfunc.jvp(inner, (xi,), (e,))
    return value, d1, d2


def gradient_fn(f: Callable) -> Callable:
    """∇f for a per-point scalar function: returns ``xi -> (d,)``."""
    return tfunc.grad(_scalarize(f))


def jacobian_fn(f: Callable) -> Callable:
    """Jacobian of a per-point vector function: returns ``xi -> (m, d)``."""
    return tfunc.jacfwd(f)


def divergence_fn(f: Callable, dim: int) -> Callable:
    """∇·f for a per-point vector field ``xi -> (m,)`` with m >= dim, by
    ``dim`` jvps (no Jacobian materialized)."""

    def div(xi):
        basis = _basis(xi)
        return sum(tfunc.jvp(f, (xi,), (basis[k],))[1][k]
                   for k in range(dim))

    return div


def hessian_diag_fn(f: Callable, dim: int) -> Callable:
    """Diagonal of the Hessian of a per-point scalar function:
    ``xi -> (dim,)``."""
    fs = _scalarize(f)

    def hdiag(xi):
        basis = _basis(xi)
        return torch.stack([_jet2(fs, xi, basis[k])[2] for k in range(dim)])

    return hdiag


def laplacian_fn(f: Callable, dim: int) -> Callable:
    """Δf for a per-point scalar function: the sum of the ``dim`` second
    directional derivatives along the axes."""
    fs = _scalarize(f)

    def lap(xi):
        basis = _basis(xi)
        total = torch.zeros((), dtype=xi.dtype, device=xi.device)
        for k in range(dim):
            total = total + _jet2(fs, xi, basis[k])[2]
        return total

    return lap


def taylor_bundle(f: Callable, dim: int) -> Callable:
    """(value (m,), jac (m, dim), hdiag (m, dim)) of a per-point vector
    field ``f: xi (d,) -> (m,)``, one nested jvp per input column."""

    def bundle(xi):
        basis = _basis(xi)
        value, jac_cols, hdiag_cols = None, [], []
        for k in range(dim):
            value, d1, d2 = _jet2(f, xi, basis[k])
            jac_cols.append(d1)
            hdiag_cols.append(d2)
        return value, torch.stack(jac_cols, dim=-1), torch.stack(
            hdiag_cols, dim=-1)

    return bundle


def vgrad(f: Callable, xs: torch.Tensor) -> torch.Tensor:
    return tfunc.vmap(gradient_fn(f))(xs)


def vlaplacian(f: Callable, xs: torch.Tensor, dim: int) -> torch.Tensor:
    return tfunc.vmap(laplacian_fn(f, dim))(xs)


def vdivergence(f: Callable, xs: torch.Tensor, dim: int) -> torch.Tensor:
    return tfunc.vmap(divergence_fn(f, dim))(xs)


def vtaylor_bundle(f: Callable, xs: torch.Tensor, dim: int):
    return tfunc.vmap(taylor_bundle(f, dim))(xs)


def mlp_taylor_batched(params, x: torch.Tensor, dim: int,
                       activation=torch.tanh):
    """(value (N, d_out), jac (N, d_out, dim), hdiag (N, d_out, dim)).

    params: list of {"kernel", "bias"}; x: (N, d_in).  Exact only for tanh
    (the derivative formulas below are tanh's)."""
    n, d_in = x.shape
    a = x
    eye = torch.eye(d_in, dtype=x.dtype, device=x.device)
    g = [eye[k].expand(n, d_in) for k in range(dim)]
    h = [torch.zeros(n, d_in, dtype=x.dtype, device=x.device)
         for _ in range(dim)]
    n_layers = len(params)
    for li, layer in enumerate(params):
        W, b = layer["kernel"], layer["bias"]
        z = a @ W + b
        gz = [gk @ W for gk in g]
        hz = [hk @ W for hk in h]
        if li < n_layers - 1:
            t = activation(z)
            tp = 1.0 - t * t          # tanh'
            tpp = -2.0 * t * tp       # tanh''
            a = t
            g = [tp * gzk for gzk in gz]
            h = [tpp * gzk * gzk + tp * hzk for gzk, hzk in zip(gz, hz)]
        else:
            a, g, h = z, gz, hz
    return a, torch.stack(g, dim=-1), torch.stack(h, dim=-1)


# ---------------------------------------------------------------------------
# Tape-style surface (nisaba tens_style contract)
# ---------------------------------------------------------------------------


def _input_grad(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-point ∂y/∂x of a per-point quantity y (N,) over a watched batch x
    (N, d): the gradient of Σ y, since each row of y depends on its own row
    of x only.  The graph is kept, so the result can be differentiated
    again (higher derivatives, parameter gradients)."""
    if not x.requires_grad or not y.requires_grad:
        raise ValueError(
            "This tensor is not differentiable w.r.t. the watched input: it "
            "was not computed from a batch watched by an active "
            "GradientTape (tape.watch(x) before model(x)).")
    (g,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    return g


def gradient_scalar(tape, u: torch.Tensor, x: torch.Tensor,
                    dim: int | None = None) -> torch.Tensor:
    """∂u/∂x for a scalar field u ((N,) or (N, 1)) at N points → (N, d).

    Columns are indexed by input coordinate (column 0 is t in the unsteady
    layout).  The result can be differentiated again: a second derivative
    is a gradient_scalar of one of its columns."""
    return _input_grad(u.reshape(u.shape[0]), x)


def divergence_vector(tape, u_vect: torch.Tensor, x: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """∇·u = Σ_{k<dim} ∂u_k/∂x_k for an (N, m ≥ dim) vector field → (N,)."""
    return sum(_input_grad(u_vect[:, k], x)[:, k] for k in range(dim))


def laplacian_scalar(tape, u: torch.Tensor, x: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """Δu = Σ_{k<dim} ∂²u/∂x_k² for a scalar field at N points → (N,)."""
    g = _input_grad(u.reshape(u.shape[0]), x)
    return sum(_input_grad(g[:, k], x)[:, k] for k in range(dim))


def laplacian_vector(tape, u_vect: torch.Tensor, x: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """Component-wise Δu for an (N, m) vector field → (N, m)."""
    return torch.stack([laplacian_scalar(tape, u_vect[:, m], x, dim)
                        for m in range(u_vect.shape[1])], dim=-1)
