"""Differential operators: the closed-form batched Taylor propagation
through a tanh MLP, and the tape-style surface of nisaba's ``tens_style``.

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

import torch


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
