"""OptimizationProblem: the model, its training and test losses, the
history they are logged into and the callbacks fired at log points
(nisaba's ``ns.OptimizationProblem``).

The model is given as ``model.variables``, as nisaba's cases pass it, or as
the model itself.  Two flat views of the parameters serve the optimizers,
both in the JAX package's ``ravel_pytree`` order: a float64 host vector for
the scipy round, and a device tensor for the on-device rounds (no host
copy per evaluation).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpinn_torch.history import History
from tpinn_torch.losses import Loss
from tpinn_torch.models import Model, VariablesHandle

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

    @property
    def params(self) -> List[torch.Tensor]:
        return self.model.flat_params()

    def loss_fn(self) -> torch.Tensor:
        """Global training loss Σ weight_i · raw_i at the current params."""
        total = 0.0
        for loss in self.losses:
            total = total + loss.weight * loss.raw_value()
        return total

    @torch.no_grad()
    def eval_all(self):
        """(loss_global, {train raw}, {test raw}) as Python floats, read
        from the device in one transfer."""
        names = [l.name for l in self.losses] + [l.name for l in self.losses_test]
        raws = [l.raw_value() for l in self.losses + self.losses_test]
        values = torch.stack([torch.as_tensor(r) for r in raws]).tolist()
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
        gradient."""
        self.set_flat(theta)
        order = self._vector_order()
        loss = self.loss_fn()
        grads = torch.autograd.grad(loss, order, materialize_grads=True)
        return loss.detach(), torch.cat([g.reshape(-1) for g in grads])

    def _residual_vector(self) -> torch.Tensor:
        parts = []
        for loss in self.losses:
            r = (loss.fn() / loss.normalization).reshape(-1)
            parts.append(math.sqrt(loss.weight / r.numel()) * r)
        return torch.cat(parts)

    def residuals_and_grad(self, theta: torch.Tensor):
        """(R, 2·JᵀR) at ``theta`` through one backward: the stacked
        residual vector of ``residuals_at`` (||R||² is the global loss) and
        the gradient of ||R||², both on the device; the model keeps
        ``theta``."""
        self.set_flat(theta)
        order = self._vector_order()
        R = self._residual_vector()
        grads = torch.autograd.grad(R, order, grad_outputs=2.0 * R.detach(),
                                    materialize_grads=True)
        return R.detach(), torch.cat([g.reshape(-1) for g in grads])

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

    def residuals_split(self, hi: torch.Tensor, lo: torch.Tensor):
        """(r, dr, g) at the two-float point (hi, lo): r = R(hi), the
        correction channel dr = J(hi)·lo kept apart from it, and
        g = 2·J(hi)ᵀ(r + dr), the gradient of ||R||² at hi + lo to first
        order in lo."""
        R, th, JTu, u = self._linearize(hi)
        (dr,) = torch.autograd.grad(JTu, u, lo, retain_graph=True)
        r = R.detach()
        (g,) = torch.autograd.grad(R, th, 2.0 * (r + dr))
        return r, dr, g

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
        order = self._vector_order()
        loss = self.loss_fn()
        grads = torch.autograd.grad(loss, order, materialize_grads=True)
        both = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        out = both.cpu().numpy().astype(np.float64)
        return float(out[0]), out[1:]

    def save_history(self, path) -> None:
        self.history.save(path)

    def fire_callbacks(self, iteration: int, force: bool = False) -> None:
        for cb in self.callbacks:
            cb(self, iteration, force=force)
