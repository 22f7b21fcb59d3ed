"""Closed-form batched Taylor propagation through a tanh MLP.

This is the plain PyTorch twin of the CUDA residual kernels' stream math
(tpinn_torch/kernels/csrc/ns_residual.cu): for every point it carries the
value, one first-derivative stream per input column and one
Hessian-diagonal stream per input column through the layers,

    v' = tanh(z_v);  g'_k = tanh'(z_v) z_gk;
    h'_k = tanh''(z_v) z_gk² + tanh'(z_v) z_hk,

with the bias on the value stream only.
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
