"""Point-axis data parallelism over a mesh of ranks (``torch.distributed``).

The workload's natural parallel axis is the collocation / boundary /
fitting **point batch**: every loss is a mean of per-point residuals, so
sharding the points over a 1-D mesh turns each mean into a local share plus
one sum over the mesh.  The parameters (a few thousand floats) are
replicated.

The JAX package runs one controller over a device mesh and lets XLA insert
the sums.  Here every rank is a process that runs the whole driver (SPMD,
as DDP does): the mesh is a ``DeviceMesh`` named "points" over the process
group, each rank keeps its own rows of every point batch, and every sum is
an explicit ``all_reduce`` on the mesh's group, one per evaluation: the
loss, its gradient and the logged raw losses travel in one flat buffer
(``OptimizationProblem``), and the Levenberg–Marquardt round reduces JᵀJ
and Jᵀr together.  Each rank's share is normalized by the global count, so
every reduction is a plain sum and the means are exact for any batch
length: padding rows are masked (the fused kernels' valid-row count) or
scaled to zero (``shard_pair``).  A loss that every rank computes whole
(a ``Loss`` without a mesh, such as the PRESS_0 gauge) is counted once, on
rank 0.  Every branch of the optimizers reads reduced values only, so θ
stays bit-identical on every rank; rank 0 alone writes files.

Usage, in every rank of a process group that ``torchrun`` (or
:func:`spawn`) started::

    mesh = tpinn_torch.sharding.point_mesh()
    drv = StandardNSDriver(spec, opts, mesh=mesh)
    drv.train()

or with the nisaba-style API: shard a batch with :func:`shard_points` or
:func:`shard_pair`, give its losses ``mesh=mesh``, and minimize as usual.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpinn_torch import config
from tpinn_torch.kernels import mlp_bundle
from tpinn_torch.profiling import span

POINT_AXIS = "points"


def point_mesh(n_devices: Optional[int] = None, devices=None):
    """The 1-D ``DeviceMesh`` named "points" over every rank of the default
    process group: the initialized one, else the one that ``torchrun``'s
    environment describes, initialized here (NCCL on the card, gloo on the
    CPU; several ranks sharing one card need gloo, initialized by the
    caller).  ``n_devices``, when given, must be the group's size;
    ``devices`` names the device type the ranks compute on (default: the
    card; "cpu" for the plain versions)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = config.resolve_device(devices).type
    if not dist.is_initialized():
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                             "MASTER_ADDR")):
            raise RuntimeError(
                "point_mesh: no process group; start the ranks with "
                "torchrun or tpinn_torch.sharding.spawn, or call "
                "torch.distributed.init_process_group first")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a point mesh spans every rank of the process "
                         f"group: {world} ranks, not {n_devices}")
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(POINT_AXIS,))


def _placements():
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:  # PyTorch before 2.4
        from torch.distributed._tensor import Replicate, Shard
    return Replicate, Shard


def point_sharding(mesh):
    """The placement of a point batch on the mesh: rows sharded."""
    return (_placements()[1](0),)


def replicated(mesh):
    """The placement of the parameters on the mesh: replicated."""
    return (_placements()[0](),)


def mesh_size(mesh) -> int:
    """The mesh's rank count (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.size())


def mesh_rank(mesh) -> int:
    """This process's rank on the mesh (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank())


def _src(mesh) -> int:
    """The global rank of the mesh's rank 0."""
    return int(mesh.mesh.reshape(-1)[0])


def all_reduce_sum(mesh, *tensors: torch.Tensor):
    """The tensors summed over the mesh in one collective: flattened into
    one buffer (one dtype), reduced, split back into new tensors of their
    shapes.  Without a mesh the tensors come back as they are."""
    if mesh is None:
        return tensors
    buf = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(buf, group=mesh.get_group())
    out, off = [], 0
    for t in tensors:
        out.append(buf[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return tuple(out)


def all_ranks(mesh, flag: bool, device=None) -> bool:
    """True when ``flag`` holds on every rank of the mesh (one collective);
    ``flag`` itself without a mesh."""
    if mesh is None:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.get_group())
    with span("host_read"):
        return bool(t.item() == 1.0)


def on_rank0(mesh, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on the mesh's rank 0 alone, its result
    broadcast to every rank, which waits for it (so that a file rank 0
    writes exists before any rank reads it).  Without a mesh, the call."""
    if mesh is None:
        return fn(*args, **kwargs)
    out = [fn(*args, **kwargs) if mesh_rank(mesh) == 0 else None]
    dist.broadcast_object_list(out, src=_src(mesh), group=mesh.get_group())
    return out[0]


def pad_to_multiple(arr, multiple: int, axis: int = 0, pad_value=0.0):
    """Pad the point axis with ``pad_value`` so that it divides evenly
    across the mesh: (padded tensor, original length)."""
    arr = torch.as_tensor(arr)
    n = int(arr.shape[axis])
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    shape = list(arr.shape)
    shape[axis] = rem
    pad = torch.full(shape, pad_value, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], dim=axis), n


def _repeat_last(a: torch.Tensor, k: int) -> torch.Tensor:
    return torch.cat([a, a[-1:].expand(k, *a.shape[1:])])


def _rows(a: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch whose length divides the mesh (a copy,
    so that the whole batch can be freed)."""
    per = a.shape[0] // mesh_size(mesh)
    r = mesh_rank(mesh)
    return a[r * per:(r + 1) * per].clone()


def shard_points(arr, mesh, pad: bool = True) -> torch.Tensor:
    """This rank's rows of an (N, ...) point batch.  If N does not divide
    the mesh size and ``pad`` is True, the batch is first padded by
    repeating its final point (nearly exact means; the fused kernels mask
    the padding with their valid-row count, and :func:`shard_pair` scales it
    to zero)."""
    arr = torch.as_tensor(arr)
    n_dev = mesh_size(mesh)
    if arr.shape[0] % n_dev != 0:
        if not pad:
            raise ValueError(f"point count {arr.shape[0]} not divisible by "
                             f"mesh size {n_dev}")
        arr = _repeat_last(arr, (-arr.shape[0]) % n_dev)
    return _rows(arr, mesh)


def shard_pair(x, rhs_list: Sequence, mesh):
    """Shard an rhs-paired point batch exactly, whatever its length.

    Pads ``x`` (repeating the last point) and every same-length rhs array
    (repeating its last entry) up to the next multiple of the mesh size,
    and makes a mask-scale vector ``m`` with ``m[:n] = sqrt(n_pad/n)`` and
    ``m[n:] = 0``, so that mean((m·r)²) over the padded batch equals
    mean(r²) over the original one.  Scalar rhs entries pass through.

    Returns ``(x_rows, rhs_rows_list, scale_rows)``: this rank's rows of
    each; the scale is None when no padding was needed."""
    x = torch.as_tensor(x)
    n = int(x.shape[0])
    n_dev = mesh_size(mesh)
    k = (-n) % n_dev

    def place(r):
        if not torch.is_tensor(r) and np.ndim(r) == 0:
            return r
        r = torch.as_tensor(r)
        if r.dim() == 0:
            return r
        return _rows(r if k == 0 else _repeat_last(r, k), mesh)

    xs = _rows(x if k == 0 else _repeat_last(x, k), mesh)
    rs = [place(r) for r in rhs_list]
    if k == 0:
        return xs, rs, None
    scale = torch.cat([
        torch.full((n,), float(np.sqrt((n + k) / n)), dtype=x.dtype,
                   device=x.device),
        torch.zeros((k,), dtype=x.dtype, device=x.device)])
    return xs, rs, _rows(scale, mesh)


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


@torch.no_grad()
def replicate(tree, mesh):
    """Make a parameter pytree (tensors of one dtype and device in dicts,
    lists, tuples) equal on every rank: each leaf takes rank 0's values, in
    place, by one broadcast.  Returns the tree."""
    leaves = _leaves(tree)
    buf = torch.cat([t.reshape(-1) for t in leaves])
    dist.broadcast(buf, src=_src(mesh), group=mesh.get_group())
    off = 0
    for t in leaves:
        t.copy_(buf[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return tree


def _local_valid_count(n_true: int, per_shard: int, rank: int) -> int:
    """Valid-row count of shard ``rank``: it holds rows
    [rank·per, (rank+1)·per) of the padded batch and the padding lies at the
    end, so the count is clip(n_true − rank·per, 0, per)."""
    return int(min(max(n_true - rank * per_shard, 0), per_shard))


def shard_counts(x: torch.Tensor, mesh, n_true: Optional[int]):
    """(n_valid, n_mean) of this rank's shard ``x`` of a batch of ``n_true``
    rows (default: every row of every shard valid): the fused kernels' mask
    and the global mean denominator, so that the shard's result is its
    share of the exact global mean."""
    per = int(x.shape[0])
    n_true = per * mesh_size(mesh) if n_true is None else int(n_true)
    return _local_valid_count(n_true, per, mesh_rank(mesh)), n_true


class _SumOverMesh(torch.autograd.Function):
    """Forward: the tensors summed over the mesh (one collective).
    Backward: the cotangent, replicated, passes to every rank's share."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        return all_reduce_sum(mesh, *tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _ReplicatedGrad(torch.autograd.Function):
    """Forward: the replicated parameters as they are.  Backward: each
    rank's gradient summed over the mesh (one collective), so that every
    rank holds the global dW/db."""

    @staticmethod
    def forward(ctx, mesh, *flat):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in flat)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_reduce_sum(ctx.mesh, *grads))


def _replicated_params(params, mesh):
    flat = [t for p in params for t in (p["kernel"], p["bias"])]
    if not any(t.requires_grad for t in flat):
        return params
    out = _ReplicatedGrad.apply(mesh, *flat)
    return [{"kernel": out[2 * i], "bias": out[2 * i + 1]}
            for i in range(len(params))]


def sharded_ns_residual_mse(params, x, physics, norm, mesh,
                            n_true: Optional[int] = None):
    """The three NS-residual MSEs of a sharded batch, exact for any batch
    length: each rank runs ``ns_residual_mse`` (kernel 2 forward, kernel 1
    backward; the plain version on the CPU) on its shard ``x`` with its
    valid-row count and the global mean denominator ``n_true`` (default:
    every row valid), and one sum over the mesh combines the shares.  The
    gradient w.r.t. the replicated ``params`` is the global one on every
    rank (each rank's share, summed over the mesh).  ``x`` is this rank's
    rows of the batch padded to a multiple of the mesh size
    (:func:`shard_points`)."""
    n_valid, n_mean = shard_counts(x, mesh, n_true)
    m = mlp_bundle.ns_residual_mse(_replicated_params(params, mesh), x,
                                   physics, norm, n_valid=n_valid,
                                   n_mean=n_mean)
    return _SumOverMesh.apply(mesh, m)[0]


def sharded_ns_weighted_obj(params, x, physics, norm, weights, mesh,
                            n_true: Optional[int] = None):
    """The one-pass training objective of a sharded batch: each rank runs
    ``ns_residual_weighted_obj`` (kernel 1 with the loss weights as
    cotangents; the plain version on the CPU) on its shard with its
    valid-row count and the global mean denominator, and one sum over the
    mesh combines the (weighted loss, three MSEs).  Exact for any batch
    length (see :func:`sharded_ns_residual_mse`); the gradient of the loss
    w.r.t. the replicated ``params`` is the global one on every rank; the
    MSEs are log channels."""
    n_valid, n_mean = shard_counts(x, mesh, n_true)
    loss, mses = mlp_bundle.ns_residual_weighted_obj(
        _replicated_params(params, mesh), x, physics, norm, weights,
        n_valid=n_valid, n_mean=n_mean)
    loss, mses = _SumOverMesh.apply(mesh, loss, mses)
    return loss, mses.detach()


# ---------------------------------------------------------------------------
# starting ranks without torchrun
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _rank_main(rank, fn, world, port, backend, device, timeout, threads,
               args):
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    try:
        fn(rank, point_mesh(devices=dev.type), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), backend: str = "gloo",
          device: str = "cpu", timeout: float = 60.0,
          threads: Optional[int] = 1,
          deadline: Optional[float] = None) -> None:
    """Run ``fn(rank, mesh, *args)`` in ``nprocs`` new processes, each a
    rank of a process group (``backend``, a localhost address on a free
    port, collectives timing out after ``timeout`` seconds) with its point
    mesh on ``device`` ("cuda": rank r on card r mod the card count;
    "cuda:i": every rank on card i).  ``fn`` must be importable by name (a
    module-level function: the processes start fresh).  Each rank uses
    ``threads`` CPU threads (PyTorch's and the host BLAS's).  Returns when every rank has returned; raises
    when a rank raises or dies, after stopping the others, and when
    ``deadline`` seconds pass first."""
    import torch.multiprocessing as mp

    # the host BLAS's threads too (numpy's eigh, scipy): ranks sharing the
    # cores must not each start a thread per core
    blas = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in blas}
    if threads:
        os.environ.update({k: str(threads) for k in blas})
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, _free_port(), backend, device,
                              timeout, threads, args),
            nprocs=nprocs, join=False, start_method="spawn")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    end = None if deadline is None else time.monotonic() + deadline
    try:
        while not ctx.join(timeout=1.0):
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f"ranks still running after {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
