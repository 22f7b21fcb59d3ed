"""Runs on a point mesh of spawned ranks, each rank recording what it ended
with, for holding the sharded port against an unsharded run.

    from tpinn_torch import sharded_runs, sharding
    sharding.spawn(sharded_runs.run_jobs, 3, args=(jobs, out_dir))
    results = sharded_runs.load(out_dir, 3)   # one list of job results per rank

A job is a dict, run on every rank in turn:

* ``{"kind": "driver", ...}`` (the default): a ``StandardNSDriver`` of a
  case module (``"case"``, with ``build_spec`` and ``default_options``),
  its spec's fields replaced by ``"spec"`` and the options' by ``"opts"``,
  built on the rank's mesh from ``"arrays"`` (``from_arrays``) when given,
  with the keyword arguments ``"driver"``.  Then: ``"eval"`` logs the
  evaluation at θ0; ``"rounds"`` runs rounds on an ``OptimizationProblem``
  of its losses (``["keras", n]`` Adam at the driver's rate, any other name
  through ``run_second_round``), θ recorded after each; or ``"train"``
  passes keyword arguments to ``train`` (``resume_from="@prev"``: the
  previous job's run folder), and ``"save_artifacts"`` writes the run
  folder (``"save_experiment"``: its experiment files alone).  ``"env"``
  sets environment variables around the job.
* ``{"kind": "objectives", ...}``: the sharding functions on given arrays:
  ``pad_to_multiple``, ``shard_points``, ``shard_pair`` and the two sharded
  NS objectives with their parameter gradients.
* ``{"kind": "entry_step", "dtype": ..., "device": ..., "params": ...}``:
  the dry run's path 2 (``tpinn_torch.entry.sharded_step``): one Adam step
  of the sharded fused objective on a batch that does not divide the mesh,
  the one-pass objective against the fwd+bwd pair, the masked mean against
  the unsharded kernel.  The dry run's paths 3 and 4 are driver jobs of
  the case ``tpinn_torch.entry``.

A job with ``"fail_rank": r`` raises on rank r before its first collective
(a failing rank must stop the run, not hang it).
"""

from __future__ import annotations

import importlib
import os
import pickle
import time
from typing import List, Optional

import numpy as np
import torch

from tpinn_torch import sharding
from tpinn_torch.driver import StandardNSDriver, run_second_round
from tpinn_torch.kernels import mlp_bundle
from tpinn_torch.optimize import minimize
from tpinn_torch.optimizers import Adam
from tpinn_torch.pipeline import NSPhysics
from tpinn_torch.problem import OptimizationProblem


def _np(t):
    return t.detach().cpu().numpy()


def _driver_job(rank, mesh, job, prev):
    case = importlib.import_module(job["case"])
    spec = case.build_spec()
    for k, v in job.get("spec", {}).items():
        setattr(spec, k, v)
    opts = case.default_options()
    for k, v in job.get("opts", {}).items():
        setattr(opts, k, v)
    kw = dict(job.get("driver", {}), mesh=mesh)
    if job.get("arrays") is not None:
        drv = StandardNSDriver.from_arrays(spec, opts, **job["arrays"], **kw)
    else:
        drv = StandardNSDriver(spec, opts, **kw)
    out = {"thetas": [], "launches": [], "seconds": []}
    pb = OptimizationProblem(drv.model, drv.losses, drv.losses_test)
    if job.get("eval"):
        out["eval"] = pb.eval_all()
    for name, n in job.get("rounds", []):
        mlp_bundle.reset_launch_counts()
        t0 = time.perf_counter()
        if name == "keras":
            minimize(pb, "keras", Adam(learning_rate=drv.adam_lr),
                     num_epochs=n)
        else:
            run_second_round(pb, name, n, scipy_method=drv.scipy_method)
        _sync(drv.device)
        out["seconds"].append(time.perf_counter() - t0)
        out["launches"].append(dict(mlp_bundle.LAUNCHES))
        out["thetas"].append(pb.get_vector().tobytes())
    if "train" in job:
        train = dict(job["train"])
        if train.get("resume_from") == "@prev":
            train["resume_from"] = prev["folder"]
        mlp_bundle.reset_launch_counts()
        pb = drv.train(**train)
        out["launches"].append(dict(mlp_bundle.LAUNCHES))
        out["thetas"].append(pb.get_vector().tobytes())
        if job.get("save_artifacts"):
            drv.save_artifacts()
        elif job.get("save_experiment"):
            drv.save_experiment()
    out["folder"] = drv.folder
    out["callbacks"] = len(pb.callbacks)
    out["history"] = pb.history.to_dict()
    for key in ("lm_used_fast_gram", "lm_solver", "bfgs_counts",
                "lbfgs_counts", "lm_rungs", "lm_times"):
        if hasattr(pb, key):
            out[key] = getattr(pb, key)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _objectives_job(rank, mesh, job):
    device = job.get("device", "cpu")
    dtype = torch.float64
    out = {}
    for name, arr in job.get("points", {}).items():
        a = torch.as_tensor(arr, dtype=dtype)
        out[f"pad {name}"] = _np(sharding.pad_to_multiple(
            a, sharding.mesh_size(mesh))[0])
        out[f"points {name}"] = _np(sharding.shard_points(a, mesh))
    for name, (x, rhs) in job.get("pairs", {}).items():
        xs, rs, scale = sharding.shard_pair(
            torch.as_tensor(x, dtype=dtype),
            [r if np.ndim(r) == 0 else torch.as_tensor(r, dtype=dtype)
             for r in rhs], mesh)
        out[f"pair {name}"] = (_np(xs), [r if np.ndim(r) == 0 else _np(r)
                                         for r in rs],
                               None if scale is None else _np(scale))
    physics = NSPhysics(**job.get("physics", {}))
    for name, (x, n_true) in job.get("batches", {}).items():
        params = [{k: torch.tensor(p[k], dtype=dtype, device=device,
                                   requires_grad=True)
                   for k in ("kernel", "bias")} for p in job["params"]]
        flat = [t for p in params for t in (p["kernel"], p["bias"])]
        x = torch.as_tensor(x, dtype=dtype)
        xs = sharding.shard_points(x, mesh).to(device)
        n_valid, n_mean = sharding.shard_counts(xs, mesh, n_true)
        loss, mses = sharding.sharded_ns_weighted_obj(
            params, xs, physics, job["norm"], job["weights"], mesh,
            n_true=n_true)
        g_obj = torch.autograd.grad(loss, flat)
        m = sharding.sharded_ns_residual_mse(params, xs, physics, job["norm"],
                                             mesh, n_true=n_true)
        ct = torch.tensor(job["cotangent"], dtype=dtype, device=device)
        g_mse = torch.autograd.grad(torch.dot(m, ct), flat)
        out[f"batch {name}"] = {
            "n_valid": n_valid, "n_mean": n_mean, "loss": _np(loss),
            "mses": _np(mses), "grads": [_np(g) for g in g_obj],
            "mse": _np(m), "mse_grads": [_np(g) for g in g_mse]}
    return out


def run_job(rank: int, mesh, job: dict, prev: Optional[dict] = None):
    """One job on this rank (``mesh`` None: the same job unsharded, in one
    process); ``prev`` is the previous job's result.  Returns its
    result."""
    if job.get("fail_rank") == rank:
        raise RuntimeError(f"rank {rank} fails, as the job asks")
    env = job.get("env", {})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        kind = job.get("kind", "driver")
        if kind == "objectives":
            return _objectives_job(rank, mesh, job)
        if kind == "entry_step":
            from tpinn_torch import entry

            return entry.sharded_step(mesh, getattr(torch, job["dtype"]),
                                      job.get("device", "cpu"),
                                      job.get("params"))
        return _driver_job(rank, mesh, job, prev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_jobs(rank: int, mesh, jobs: List[dict], out_dir: str) -> None:
    """Run ``jobs`` in turn on this rank, then write their results to
    ``out_dir/rank{rank}.pkl``."""
    results = []
    for job in jobs:
        results.append(run_job(rank, mesh, job,
                               results[-1] if results else None))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def load(out_dir: str, nprocs: int) -> List[list]:
    """Every rank's job results, by rank."""
    out = []
    for r in range(nprocs):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
