"""OptimizationProblem: the model, its training and test losses, the
history they are logged into and the callbacks fired at log points
(nisaba's ``ns.OptimizationProblem``).

The model is given as ``model.variables``, as nisaba's cases pass it, or as
the model itself.  Two flat views of the parameters serve the optimizers,
both in the JAX package's ``ravel_pytree`` order: a float64 host vector for
the scipy round, and a device tensor for the on-device rounds (no host
copy per evaluation).

Under a point mesh (the mesh of its sharded losses) every evaluation the
rounds call sums the ranks' shares in one collective: the
loss with its gradient, the logged raw losses, the paired loss change with
its gradient.  The residual vectors (``residuals_at``, ``residuals_flat``,
``residuals_jvp``, ``residuals_jacobian``) are this rank's rows, each
scaled by the global count, so that ||R||² sums to the global loss; their
consumers reduce what they make of them (``mesh_sum``).  A loss without a
mesh is computed whole on every rank and counted on rank 0 alone.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpinn_torch import sharding
from tpinn_torch.history import History
from tpinn_torch.losses import Loss
from tpinn_torch.models import Model, VariablesHandle
from tpinn_torch.profiling import span

# parameter tangents per block of the chunked Jacobian (the JAX package's
# LM chunk)
JAC_CHUNK = 256


class OptimizationProblem:
    def __init__(
        self,
        variables: Union[VariablesHandle, Model],
        losses: Sequence[Loss],
        losses_test: Union[Loss, Sequence[Loss], None] = None,
        callbacks: Optional[list] = None,
    ):
        if isinstance(variables, VariablesHandle):
            variables = variables.model
        if not isinstance(variables, Model):
            raise TypeError("variables must be model.variables or a "
                            "tpinn_torch Model")
        self.model = variables
        self.losses: List[Loss] = list(losses)
        if losses_test is None:
            losses_test = []
        if isinstance(losses_test, Loss):
            losses_test = [losses_test]
        self.losses_test: List[Loss] = list(losses_test)
        self.callbacks: list = list(callbacks) if callbacks else []
        self.history = History()
        self.history.register_losses(self.losses, self.losses_test)
        # the live optimizer state of the current or last round, published
        # at every log point so that a checkpoint can resume it exactly
        # ({"kind": "lm" | "bfgs_*", ...}; None after a scipy round, whose
        # state scipy keeps); a driver resuming a run folder puts the
        # checkpointed state on ``resume_opt_state`` for the round of the
        # same kind to adopt
        self.last_opt_state = None
        self.last_round_name: Optional[str] = None
        self.resume_opt_state = None
        # the point mesh of the sharded losses (None: one process)
        self.mesh = next((l.mesh for l in self.losses + self.losses_test
                          if l.mesh is not None), None)
        self._rank = sharding.mesh_rank(self.mesh)
        self._world = sharding.mesh_size(self.mesh)

    @property
    def params(self) -> List[torch.Tensor]:
        return self.model.flat_params()

    def _counts(self, loss: Loss) -> bool:
        """Whether this rank adds ``loss`` to the mesh's sums: a sharded
        loss on every rank, a replicated one on rank 0 alone."""
        return loss.mesh is not None or self._rank == 0

    def mesh_sum(self, *tensors: torch.Tensor):
        """The tensors summed over the mesh in one collective (as they are
        without a mesh)."""
        return sharding.all_reduce_sum(self.mesh, *tensors)

    def loss_fn(self) -> torch.Tensor:
        """Global training loss Σ weight_i · raw_i at the current params;
        under a mesh, this rank's share of it."""
        total = 0.0
        for loss in self.losses:
            if self._counts(loss):
                total = total + loss.weight * loss.raw_value()
        return total

    def loss_and_grads(self, tensors: Sequence[torch.Tensor]):
        """(global loss, its gradients w.r.t. ``tensors``); a tensor the
        loss does not read gets a zero gradient.  Under a mesh the ranks'
        shares and gradients are summed in one collective."""
        with span("objective"):
            with span("objective.forward"):
                loss = self.loss_fn()
            with span("objective.backward"):
                grads = torch.autograd.grad(loss, tensors,
                                            materialize_grads=True)
            if self.mesh is None:
                return loss, grads
            with span("objective.allreduce"):
                loss, *grads = self.mesh_sum(loss.reshape(()), *grads)
            return loss, grads

    @torch.no_grad()
    def eval_all(self):
        """(loss_global, {train raw}, {test raw}) as Python floats, read
        from the device in one transfer (summed over the mesh in one
        collective before it)."""
        names = [l.name for l in self.losses] + [l.name for l in self.losses_test]
        zero = torch.zeros((), dtype=self.model.dtype, device=self.model.device)
        raws = [l.raw_value() if self._counts(l) else zero
                for l in self.losses + self.losses_test]
        values = torch.stack([torch.as_tensor(r) for r in raws])
        values = self.mesh_sum(values)[0]
        with span("host_read"):
            values = values.tolist()
        n_train = len(self.losses)
        train = dict(zip(names[:n_train], values[:n_train]))
        test = dict(zip(names[n_train:], values[n_train:]))
        total = 0.0
        for l in self.losses:
            total = total + l.weight * train[l.name]
        return total, train, test

    # -- flat float64 view for host optimizers (the scipy round) -----------
    def _vector_order(self) -> List[torch.Tensor]:
        """Parameters in the JAX package's ``ravel_pytree`` order: per
        layer the bias, then the kernel (its dict keys sorted)."""
        return [t for p in self.model.params for t in (p["bias"], p["kernel"])]

    def get_vector(self) -> np.ndarray:
        """The parameters as one float64 host vector."""
        flat = torch.cat([t.detach().reshape(-1) for t in self._vector_order()])
        return flat.cpu().numpy().astype(np.float64)

    @torch.no_grad()
    def set_vector(self, vec: np.ndarray) -> None:
        """Copy a host vector into the parameters, in place: one
        host-to-device copy, then device-side copies per tensor."""
        order = self._vector_order()
        src = torch.tensor(np.asarray(vec), dtype=order[0].dtype)
        src = src.to(order[0].device)
        off = 0
        for t in order:
            n = t.numel()
            t.copy_(src[off:off + n].view_as(t))
            off += n
        if off != src.numel():
            raise ValueError(f"vector of {src.numel()} values for {off} "
                             "parameters")

    # -- flat device vector for the on-device rounds ------------------------
    def get_flat(self) -> torch.Tensor:
        """The parameters as one tensor on their device, in ravel order."""
        return torch.cat([t.detach().reshape(-1) for t in self._vector_order()])

    @torch.no_grad()
    def set_flat(self, theta: torch.Tensor) -> None:
        """Copy a flat device tensor into the parameters, in place (no host
        copy).  Every ``copy_`` bumps the parameter's version counter, which
        keys the fused objectives' memos, so the next evaluation recomputes
        even where ``theta`` holds the values the parameters already had."""
        off = 0
        for t in self._vector_order():
            n = t.numel()
            t.copy_(theta[off:off + n].view_as(t))
            off += n
        if off != theta.numel():
            raise ValueError(f"vector of {theta.numel()} values for {off} "
                             "parameters")

    def flat_value_and_grad(self, theta: torch.Tensor):
        """(loss, flat gradient) at ``theta`` as device tensors; the model
        keeps ``theta``.  A parameter the loss does not read gets a zero
        gradient.  Under a mesh both are summed in one collective."""
        self.set_flat(theta)
        loss, grads = self.loss_and_grads(self._vector_order())
        return loss.detach(), torch.cat([g.reshape(-1) for g in grads])

    def _residual_vector(self) -> torch.Tensor:
        """Each counted loss's rows, scaled by sqrt(weight / N) for N its
        global row count (the padded count under a mesh)."""
        parts = []
        for loss in self.losses:
            if not self._counts(loss):
                continue
            r = (loss.fn() / loss.normalization).reshape(-1)
            n = r.numel() * (self._world if loss.mesh is not None else 1)
            parts.append(math.sqrt(loss.weight / n) * r)
        return torch.cat(parts)

    def residuals_and_grad(self, theta: torch.Tensor, r_ref=None):
        """(R, 2·JᵀR, Δφ) at ``theta`` through one backward: the stacked
        residual vector of ``residuals_at`` (||R||² is the global loss), the
        gradient of ||R||², and Δφ = (R − r_ref)·(R + r_ref), the change of
        the loss from where the residuals were ``r_ref`` (||R||² without
        one), all on the device; the model keeps ``theta``.  Under a mesh R
        is this rank's rows, and the gradient and Δφ are summed in one
        collective."""
        self.set_flat(theta)
        order = self._vector_order()
        R = self._residual_vector()
        grads = torch.autograd.grad(R, order, grad_outputs=2.0 * R.detach(),
                                    materialize_grads=True)
        R = R.detach()
        dphi = (torch.dot(R, R) if r_ref is None
                else torch.dot(R - r_ref, R + r_ref))
        g, dphi = self.mesh_sum(torch.cat([g.reshape(-1) for g in grads]),
                                dphi)
        return R, g, dphi

    def unravel(self, theta: torch.Tensor) -> List[dict]:
        """A flat vector in ``ravel_pytree`` order as the model's
        list-of-dicts layout (reshaped slices, so the result is a function
        of ``theta`` that ``torch.func`` can differentiate)."""
        out, off = [], 0
        for p in self.model.params:
            layer = {}
            for key in ("bias", "kernel"):
                n = p[key].numel()
                layer[key] = theta[off:off + n].reshape(p[key].shape)
                off += n
            out.append(layer)
        if off != theta.shape[-1]:
            raise ValueError(f"vector of {theta.shape[-1]} values for {off} "
                             "parameters")
        return out

    @torch.no_grad()
    def residuals_flat(self, theta: torch.Tensor) -> torch.Tensor:
        """``residuals_at`` at a flat device tensor (no host copy)."""
        self.set_flat(theta)
        return self._residual_vector()

    def _linearize(self, theta: torch.Tensor):
        """The stacked residuals R at ``theta`` with the model bound to
        views of a leaf copy ``th`` of it (``Model.bind``), and Jᵀu for a
        zero u that requires grad, both graphs kept.  Jᵀc is then the
        gradient of R in th along c, and J·v the gradient of Jᵀu in u along
        v (a double backward: reverse mode only, so it runs through the
        tape's own ``autograd.grad`` where ``torch.func.jvp`` cannot).
        The module's parameters are not touched.  Returns (R, th, Jᵀu, u)."""
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad(), self.model.bind(self.unravel(th)):
            R = self._residual_vector()
            u = torch.zeros_like(R, requires_grad=True)
            (JTu,) = torch.autograd.grad(R, th, u, create_graph=True)
        return R, th, JTu, u

    def residuals_jvp(self, theta: torch.Tensor, tangent: torch.Tensor):
        """(R, J·v) at ``theta`` on the device, v a flat tangent: the
        JAX package's ``jax.jvp(residuals, (theta,), (v,))``."""
        R, _, JTu, u = self._linearize(theta)
        (Jv,) = torch.autograd.grad(JTu, u, tangent)
        return R.detach(), Jv

    def residuals_split(self, hi: torch.Tensor, lo: torch.Tensor, ref=None):
        """(r, dr, g, Δφ) at the two-float point (hi, lo): r = R(hi), the
        correction channel dr = J(hi)·lo kept apart from it,
        g = 2·J(hi)ᵀ(r + dr), the gradient of ||R||² at hi + lo to first
        order in lo, and the loss change from where the channels were
        ``ref`` = (r₀, dr₀), each channel differenced before they are added:
        Δφ = ((r − r₀) + (dr − dr₀))·((r + r₀) + (dr + dr₀)) (||r||²
        without one).  Under a mesh g and Δφ are summed in one collective."""
        R, th, JTu, u = self._linearize(hi)
        (dr,) = torch.autograd.grad(JTu, u, lo, retain_graph=True)
        r = R.detach()
        (g,) = torch.autograd.grad(R, th, 2.0 * (r + dr))
        if ref is None:
            dphi = torch.dot(r, r)
        else:
            r0, dr0 = ref
            dphi = torch.dot((r - r0) + (dr - dr0), (r + r0) + (dr + dr0))
        g, dphi = self.mesh_sum(g, dphi)
        return r, dr, g, dphi

    def residuals_jacobian(self, theta: torch.Tensor,
                           chunk: int = JAC_CHUNK):
        """(R, Jᵀ) at ``theta`` on the device, Jᵀ (P, N) built from blocks
        of ``chunk`` parameter tangents: one batched double backward per
        block (``is_grads_batched``) over one linearization."""
        R, _, JTu, u = self._linearize(theta)
        n = theta.shape[0]
        blocks = []
        for start in range(0, n, chunk):
            rows = torch.arange(start, min(start + chunk, n),
                                device=theta.device)
            V = torch.zeros((rows.shape[0], n), dtype=theta.dtype,
                            device=theta.device)
            V[torch.arange(rows.shape[0], device=theta.device), rows] = 1.0
            (Jv,) = torch.autograd.grad(JTu, u, V, retain_graph=True,
                                        is_grads_batched=True)
            blocks.append(Jv)
        return R.detach(), torch.cat(blocks)

    @torch.no_grad()
    def residuals_at(self, vec: np.ndarray) -> torch.Tensor:
        """The stacked residual vector R of the training losses at the
        parameters ``vec`` (the model keeps them): every loss must be a
        LossMeanSquares, and contributes sqrt(weight/N)·(r/normalization),
        so ||R||² equals the global loss.  R stays on the model's device."""
        self.set_vector(vec)
        return self._residual_vector()

    def value_and_grad_vector(self, vec: np.ndarray) -> Tuple[float, np.ndarray]:
        """(loss, gradient) at the parameters ``vec`` as a float and a
        float64 host vector; the model keeps ``vec``.  One copy each way.
        A parameter the loss does not read gets a zero gradient."""
        self.set_vector(vec)
        loss, grads = self.loss_and_grads(self._vector_order())
        both = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        out = both.cpu().numpy().astype(np.float64)
        return float(out[0]), out[1:]

    def save_history(self, path) -> None:
        self.history.save(path)

    def fire_callbacks(self, iteration: int, force: bool = False) -> None:
        for cb in self.callbacks:
            cb(self, iteration, force=force)
