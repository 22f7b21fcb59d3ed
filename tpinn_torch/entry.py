"""The entry points of the flagship workload: one forward step of the fused
Navier–Stokes residual, and the dry run on a point mesh of ranks (the
port's counterpart of ``__graft_entry__.py``).

* ``entry()`` — the forward step at 4,096 collocation points of the
  reference architecture (2→32→32→32→3 tanh MLP): the residual bundle
  (value, Jacobian and Hessian diagonal per point), the mass and momentum
  residuals, and 10·mean(r_mass²) + mean(r_u²) + mean(r_v²).  The bundle
  is the closed-form Taylor propagation by default and kernel 5
  (``mlp_taylor_bundle``) under ``TPINN_USE_PALLAS=1``, as the pipeline
  routes it.

* ``dryrun_multichip(n)`` — ranks on a point mesh of ``n``
  (``sharding.spawn``: one rank per card over NCCL where there are ``n``
  cards, else ``n`` gloo ranks sharing the card; gloo ranks on the CPU with
  ``device="cpu"``), each running ``sharded_runs`` jobs:

  - path 2: one Adam step of the sharded fused objective on a batch of
    64·n − 5 true rows that does not divide the mesh (kernel 2 forward and
    kernel 1 backward per shard, the padding masked by each shard's
    valid-row count), the one-pass objective against the fwd+bwd pair, and
    the masked sharded loss against the unsharded kernel on the true rows;
    in float32 at the JAX package's bars, and in float64 at the port's;
  - path 3: Adam 15 + L-BFGS 15 through ``StandardNSDriver`` on the dry
    run's Poiseuille case (``build_spec``) at n_pde 64, every batch
    non-dividing, against the same run in one process;
  - path 4: Adam 10 + LM 4 on the fast per-point Gram at n_pde 70 against
    one process; ``lm_used_fast_gram`` on every rank.

  The JAX package's path 1 (a 2-D ("points", "model") mesh with the hidden
  layers split Megatron-style) has no counterpart: the port's parallelism
  is the point axis.

    python -m tpinn_torch.entry [--ranks N] [--device cpu]

prints the entry loss, then runs the dry run (``--ranks``: default the
card count, 1 on the CPU).  Everything runs on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from tpinn_torch import config
from tpinn_torch.bridge import params_from_numpy
from tpinn_torch.config import SimulationOptions
from tpinn_torch.driver import CaseSpec
from tpinn_torch.geometry import Normalization
from tpinn_torch.models import MLP
from tpinn_torch.oracles import analytic
from tpinn_torch.pipeline import (
    NSPhysics,
    ResidualBundle,
    mass_residual,
    momentum_residual,
)

N_POINTS = 4096
WEIGHTS = (10.0, 1.0, 1.0)
# path 2's bars, by dtype: the one-pass loss (relative, plus 1e-12
# absolute), the one-pass gradients (max |Δ| over max |g|), the masked
# sharded loss against the unsharded kernel on the true rows.  float32:
# the JAX package's (__graft_entry__.py); float64: the port's kernel and
# evaluation bars (PERF.md section 2)
STEP_BARS = {torch.float32: (1e-5, 1e-4, 1e-6),
             torch.float64: (1e-11, 1e-9, 1e-10)}
# paths 3-4: the JAX package's bar on every log, and the port's: Adam 1e-10,
# the second rounds 1e-8
HISTORY_BAR = 1e-4
ADAM_BAR, ROUND_BAR = 1e-10, 1e-8
PATH3 = dict(epochs=15, n_pde=64, n_bc=10, n_vel=5, n_pres=0, n_test=30)
PATH4 = dict(epochs=4, n_pde=70, n_bc=10, n_vel=5, n_pres=0, n_test=30)


def _flagship(dtype=torch.float32, device=None):
    """(model, norm, physics) of the flagship step."""
    model = MLP(2, 3, width=32, depth=3, seed=0, dtype=dtype, device=device)
    norm = Normalization(np.array([0.0, 500.0]), np.array([0.0, 250.0]),
                         np.array([-1e4, 1e4]))
    return model, norm, NSPhysics(conv=1.0, visc=1.0)


def entry(device=None, dtype=torch.float32):
    """Returns (fn, (params, x)): the forward step of the flagship residual
    and its arguments, ``x`` the 4,096 × 2 ``np.random.default_rng(0)``
    uniform draw in ``dtype`` on the device."""
    device = config.resolve_device(device)
    model, norm, physics = _flagship(dtype, device)

    def forward_step(params, x):
        with model.bind(params):
            bundle = ResidualBundle(model, x)
            r_mass = mass_residual(bundle, norm)
            r_u = momentum_residual(bundle, 0, physics, norm)
            r_v = momentum_residual(bundle, 1, physics, norm)
        return (torch.mean(r_mass ** 2) * 10.0 + torch.mean(r_u ** 2)
                + torch.mean(r_v ** 2))

    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (N_POINTS, 2)),
                        dtype=dtype, device=device)
    return forward_step, (model.params, x)


# ---------------------------------------------------------------------------
# the dry run's case: Poiseuille on a 20 × 10 grid with its analytic
# boundary values and no traction edge (sharded_runs' case interface)
# ---------------------------------------------------------------------------


def build_spec() -> CaseSpec:
    prm = analytic.PoiseuilleParams()
    u_f = lambda x: analytic.poiseuille_u(x, prm)
    return CaseSpec(
        name="Poiseuille_Dryrun",
        extents=[(0.0, 1.0), (0.0, 0.1)],
        grid_shape=(20, 10),
        physics=NSPhysics(conv=prm.rho, visc=prm.mu),
        exact=(u_f, lambda x: analytic.poiseuille_v(x, prm),
               lambda x: analytic.poiseuille_p(x, prm)),
        bnd_val={0: {"BOT": 0.0, "TOP": 0.0, "SX": u_f},
                 1: {"BOT": 0.0, "TOP": 0.0, "SX": 0.0}},
        weights={"PDE_MASS": 1e1},
    )


def default_options() -> SimulationOptions:
    return SimulationOptions(**PATH3)


def sharded_step(mesh, dtype=torch.float32, device=None,
                 params=None) -> dict:
    """Path 2 on this rank (``mesh`` None: one process); ``params``
    (numpy, the JAX package's layout) replace the flagship's θ0.  Returns
    the losses, the deviations and θ after the Adam step (bytes)."""
    from tpinn_torch import sharding
    from tpinn_torch.kernels import mlp_bundle
    from tpinn_torch.optimizers import Adam

    device = config.resolve_device(device)
    model, norm, physics = _flagship(dtype, device)
    if params is not None:
        model.set_params(params_from_numpy(params, dtype=dtype))
    n = sharding.mesh_size(mesh)
    batch = torch.as_tensor(
        np.random.default_rng(0).uniform(0, 1, (64 * n, 2)), dtype=dtype)

    def leaves():
        return [{k: p[k].detach().clone().requires_grad_(True)
                 for k in ("kernel", "bias")} for p in model.params]

    def flat(ps):
        return [t for p in ps for t in (p["kernel"], p["bias"])]

    mlp_bundle.reset_launch_counts()
    # the whole batch divides the mesh: its loss at θ0
    x_all = sharding.shard_points(batch, mesh).to(device)
    loss, _ = sharding.sharded_ns_weighted_obj(model.params, x_all, physics,
                                               norm, WEIGHTS, mesh)
    # a batch that does not divide the mesh: shard_points tail-pads it and
    # the kernels mask the padding by their valid-row count, so the sharded
    # objective is the exact mean over the true rows
    n_true = 64 * n - 5
    x = sharding.shard_points(batch[:n_true], mesh).to(device)

    def fused_loss(ps):
        m = sharding.sharded_ns_residual_mse(ps, x, physics, norm, mesh,
                                             n_true=n_true)
        return WEIGHTS[0] * m[0] + m[1] + m[2]

    p_step = leaves()
    opt = Adam(learning_rate=1e-2)
    opt.init(flat(p_step))
    loss_f = fused_loss(p_step)
    opt.step(flat(p_step), torch.autograd.grad(loss_f, flat(p_step)))

    # the one-pass objective (loss, log MSEs and gradients from one kernel
    # per shard) against the fwd+bwd pair it replaces
    p1, p2 = leaves(), leaves()
    l1 = fused_loss(p1)
    g1 = torch.cat([g.reshape(-1) for g in
                    torch.autograd.grad(l1, flat(p1))])
    l2, _ = sharding.sharded_ns_weighted_obj(p2, x, physics, norm, WEIGHTS,
                                             mesh, n_true=n_true)
    g2 = torch.cat([g.reshape(-1) for g in
                    torch.autograd.grad(l2, flat(p2))])
    rel = float(torch.max(torch.abs(g1 - g2))
                / (torch.max(torch.abs(g1)) + 1e-30))
    # the exact mean: the unsharded kernel over the true rows
    with torch.no_grad():
        m_plain = mlp_bundle.ns_residual_mse(model.params,
                                             batch[:n_true].to(device),
                                             physics, norm)
    l_plain = float(WEIGHTS[0] * m_plain[0] + m_plain[1] + m_plain[2])
    l1, l2 = float(l1.detach()), float(l2.detach())
    return {"dtype": str(dtype), "batch": (64 * n, 2), "n_true": n_true,
            "loss": float(loss.detach()), "loss_f": float(loss_f.detach()),
            "l1": l1, "l2": l2, "l_plain": l_plain, "grad_dev": rel,
            "mask_dev": abs(l1 - l_plain) / max(abs(l_plain), 1e-30),
            "theta": b"".join(t.detach().cpu().numpy().tobytes()
                              for t in flat(p_step)),
            "launches": dict(mlp_bundle.LAUNCHES)}


def step_ok(r: dict) -> bool:
    """Path 2's checks at its dtype's bars."""
    loss_bar, grad_bar, mask_bar = STEP_BARS[getattr(torch, r["dtype"]
                                                     .split(".")[-1])]
    return (bool(np.isfinite([r["loss"], r["loss_f"]]).all())
            and abs(r["l1"] - r["l2"]) <= loss_bar * abs(r["l1"]) + 1e-12
            and r["grad_dev"] < grad_bar and r["mask_dev"] < mask_bar)


def dryrun_jobs(base_dir: str, device: str = "cpu",
                arrays: Optional[dict] = None, params=None) -> list:
    """The dry run's jobs for ``sharded_runs``: path 2 in float32 and
    float64, paths 3 and 4 (their scratch run folder under ``base_dir``);
    ``arrays`` (``from_arrays``' keywords by path, "3" and "4") and
    ``params`` (path 2's θ0) replace the port's draws."""
    arrays = arrays or {}
    driver = lambda second, adam: {"device": device, "save_results": False,
                                   "seed": 0, "second_round": second,
                                   "adam_epochs": adam, "base_dir": base_dir}
    return [
        {"kind": "entry_step", "dtype": "float32", "device": device,
         "params": params},
        {"kind": "entry_step", "dtype": "float64", "device": device,
         "params": params},
        {"case": "tpinn_torch.entry", "opts": PATH3,
         "arrays": arrays.get("3"), "driver": driver("jax", 15),
         "train": {"callbacks": False}},
        {"case": "tpinn_torch.entry", "opts": PATH4,
         "arrays": arrays.get("4"), "driver": driver("lm", 10),
         "train": {"callbacks": False}},
    ]


def history_devs(ref, got) -> dict:
    """Every logged loss of ``got`` against ``ref`` (History objects): the
    largest relative deviation over every log, and per round."""
    out = {}
    rounds = sorted(set(ref.rounds_idx))
    for key, sel in [("all", None)] + [(r, r) for r in rounds]:
        idx = [i for i, r in enumerate(ref.rounds_idx)
               if sel is None or r == sel]
        pairs = [(ref.loss_global, got.loss_global)]
        for group in ("losses", "losses_test"):
            for name, e in getattr(ref, group).items():
                pairs.append((e["log"], getattr(got, group)[name]["log"]))
        out[key] = max(float(np.max(np.abs(np.asarray(b)[idx]
                                           - np.asarray(a)[idx])
                                    / np.maximum(np.abs(np.asarray(a)[idx]),
                                                 1e-30)))
                       for a, b in pairs)
    return out


def dryrun_multichip(n_devices: int, device=None, arrays=None,
                     params=None, verbose: bool = True) -> dict:
    """Paths 2-4 on a point mesh of ``n_devices`` spawned ranks, paths 3-4
    against one process (this one); raises where a check fails, prints the
    JAX package's three lines (rank 0's numbers) and returns the
    results."""
    from tpinn_torch import sharded_runs, sharding
    from tpinn_torch.history import History

    device = config.resolve_device(device)
    if device.type == "cuda":
        nccl = torch.cuda.device_count() >= n_devices
        backend = "nccl" if nccl else "gloo"
        rank_device = "cuda" if nccl else f"cuda:{device.index or 0}"
    else:
        backend, rank_device = "gloo", "cpu"
    with tempfile.TemporaryDirectory(prefix="dryrun_") as td:
        jobs = dryrun_jobs(td, "cuda" if device.type == "cuda" else "cpu",
                           arrays, params)
        sharding.spawn(sharded_runs.run_jobs, n_devices, args=(jobs, td),
                       backend=backend, device=rank_device, timeout=120.0,
                       deadline=1200.0)
        ranks = sharded_runs.load(td, n_devices)
        # paths 3-4 in one process (this one) on the same draws
        refs = [sharded_runs.run_job(0, None, dict(job, driver=dict(
            job["driver"], device=str(device))))["history"]
            for job in jobs[2:]]
    by_job = [[r[i] for r in ranks] for i in range(len(jobs))]
    for results in by_job:
        for r in results[1:]:
            keys = ("theta", "l1", "l2") if "l1" in r else ("thetas",)
            if any(r[k] != results[0][k] for k in keys):
                raise AssertionError("ranks disagree on θ")
    steps = [results[0] for results in by_job[:2]]
    for r in steps:
        if not step_ok(r):
            raise AssertionError(f"dry-run path 2 ({r['dtype']}) fails its "
                                 f"bars: {r}")
    hist = {}
    for path, ref, results in zip((3, 4), refs, by_job[2:]):
        ref = History.from_dict(ref)
        got = History.from_dict(results[0]["history"])
        if not (ref.round_names == got.round_names and ref.iters == got.iters):
            raise AssertionError(f"path {path}: rounds {got.round_names} "
                                 f"{got.iters}, one process's "
                                 f"{ref.round_names} {ref.iters}")
        devs = history_devs(ref, got)
        hist[path] = {"rounds": got.round_names, "points": len(got.iters),
                      "devs": devs,
                      "fast_gram": [r.get("lm_used_fast_gram")
                                    for r in results],
                      "launches": [r["launches"] for r in results]}
        if (devs["all"] >= HISTORY_BAR or devs[1] >= ADAM_BAR
                or devs[2] >= ROUND_BAR):
            raise AssertionError(f"path {path}: sharded history deviates "
                                 f"from one process: {devs}")
    if hist[4]["fast_gram"] != [True] * n_devices:
        raise AssertionError(f"LM fast per-point Gram not in play: "
                             f"{hist[4]['fast_gram']}")
    s = steps[0]
    where = "cuda" if device.type == "cuda" else "plain"
    lines = [
        f"dryrun_multichip: mesh {{'points': {n_devices}}}, batch "
        f"{s['batch']}, loss {s['loss']:.4e}; fused-kernel path (point "
        f"mesh, {where}) loss {s['loss_f']:.4e} on a non-divisible batch "
        f"({s['n_true']} true rows, exact-mean masked, dev "
        f"{s['mask_dev']:.1e}); one-pass sharded objective agrees (grad dev "
        f"{s['grad_dev']:.1e})",
        f"dryrun_multichip training-deep: rounds {hist[3]['rounds']} on "
        f"{n_devices}-device point mesh (non-divisible batches), "
        f"{hist[3]['points']} logged points, max relative history "
        f"deviation {hist[3]['devs']['all']:.3e}",
        f"dryrun_multichip second-order: rounds {hist[4]['rounds']} "
        f"(per-point-Gram LM, non-divisible n_pde=70) on the "
        f"{n_devices}-device point mesh, max relative history deviation "
        f"{hist[4]['devs']['all']:.3e}",
    ]
    if verbose:
        for line in lines:
            print(line, flush=True)
    return {"lines": lines, "steps": steps, "paths": hist,
            "backend": backend, "rank_device": rank_device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the card count; "
                         "1 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    device = config.resolve_device(args.device)
    fn, fargs = entry(device)
    with torch.no_grad():
        print("entry loss:", float(fn(*fargs)))
    ranks = args.ranks or (torch.cuda.device_count()
                           if device.type == "cuda" else 1)
    dryrun_multichip(ranks, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
