#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpinn_torch) once on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, each printing its seconds; any failed check raises and the script
exits non-zero:

1. device and build: the card's name and power limit, the nvcc build of
   tpinn_torch/kernels/csrc into .cache/tpinn_torch (seconds and the ptxas
   report), TF32 switched off;
2. kernel 1 (ns_residual_bwd) against its plain PyTorch version in float64:
   widths 2-32-32-32-3 at n = 1000, n = 4099 masked to n_valid = 4000, and
   the unsteady layout (d_in = 3); loss and MSEs at rtol 1e-11, dW/db at
   rtol 1e-9 / atol 1e-12; two calls at the same parameters bit-identical;
   the float32 instantiation's error against float64;
3. kernel 2 (ns_residual_fwd) against its plain version at the same bars,
   its MSEs against kernel 1's, and ns_residual_mse's gradient (kernel 2
   forward, kernel 1 backward) against autograd;
4. the slice: the Poiseuille Adam round (100 epochs, float64, 2-32-32-32-3,
   the reference options) through tpinn_torch.cases.poiseuille_flow.main,
   with the launch counts read around it, held against the same round run
   through the plain versions on the CPU;
5. times of both kernels and their plain versions at 1,000, 262,144 and
   1,048,576 points in float32 and float64 (CUDA events around 20
   back-to-back calls at 1,000 points and around single calls above,
   median of 10 such runs).

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): float64 through the tensor cores
# 67 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s.
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
WIDTHS = (32, 32, 32)
SIZES = (1000, 262_144, 1_048_576)
REPS = 10


def phase(name):
    """Context manager printing a phase's seconds."""

    class _P:
        def __enter__(self):
            print(f"== {name}", flush=True)
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: {time.perf_counter() - self.t0:.2f} s",
                      flush=True)

    return _P()


def ns_flops_per_point(widths, d_in, bwd):
    """Floating-point operations one point needs in the NS-residual
    kernels: the per-stream layer products, the tanh stream algebra, the
    residual rows and, for the backward, the cotangent algebra, the dW/db
    contractions and the back-propagation of the stream cotangents."""
    S = 1 + d_in + 2
    L = len(widths) - 1
    f = 0
    for l in range(L):
        wi, wo = widths[l], widths[l + 1]
        f += (2 * wi * wo if l == 0 else 2 * S * wi * wo) + wo
        if l < L - 1:  # tanh, tanh', a, g streams, h streams
            f += wo * (1 + 2 + 2 + d_in + 2 * (3 if l == 0 else 5))
    f += 2 * 14 + 6  # residual rows and squares
    if not bwd:
        return f
    f += 30  # residual cotangents
    for l in range(L - 1, -1, -1):
        wi, wo = widths[l], widths[l + 1]
        if l < L - 1:
            f += wo * (6 + 1 + 3 * d_in + 2 * (7 if l > 0 else 5)
                       + d_in + 2 * 3 + 2)
        f += (3 * wi * wo if l == 0 else 2 * S * wi * wo) + wo
        if l > 0:
            f += 2 * S * wi * wo
    return f


def random_params(rng, widths, dtype, device):
    import torch

    params = []
    for wi, wo in zip(widths[:-1], widths[1:]):
        lim = (6.0 / (wi + wo)) ** 0.5
        params.append({
            "kernel": torch.tensor(rng.uniform(-lim, lim, (wi, wo)),
                                   dtype=dtype, device=device),
            "bias": torch.tensor(rng.uniform(-0.1, 0.1, wo), dtype=dtype,
                                 device=device),
        })
    return params


def problem(d_in, n, seed, dtype, device):
    """A seeded batch, params and physics: the Poiseuille coefficients and
    normalization for the steady layout, unit coefficients unsteady."""
    import numpy as np
    import torch

    from tpinn_torch.geometry import Normalization
    from tpinn_torch.oracles import analytic
    from tpinn_torch.pipeline import NSPhysics

    rng = np.random.default_rng(seed)
    widths = (d_in,) + WIDTHS + (3,)
    params = random_params(rng, widths, dtype, device)
    if d_in == 2:
        x = rng.uniform(0.0, 1.0, (n, 2)) * np.array([1.0, 0.1])
        prm = analytic.PoiseuilleParams()
        g = torch.tensor(x)
        norm = Normalization(analytic.poiseuille_u(g, prm),
                             analytic.poiseuille_v(g, prm),
                             analytic.poiseuille_p(g, prm))
        physics = NSPhysics(conv=prm.rho, visc=prm.mu)
    else:
        x = rng.uniform(0.0, 1.0, (n, 3))
        norm = Normalization(np.array([0.0, 1.0]), np.array([0.0, 1.0]),
                             np.array([-2.0, 2.0]))
        physics = NSPhysics(conv=1.0, visc=1.0, time=1.0)
    return params, torch.tensor(x, dtype=dtype, device=device), physics, norm


def flat(params):
    return [t for p in params for t in (p["kernel"], p["bias"])]


def rel(a, b):
    import torch

    return float(torch.max(torch.abs(a - b) / torch.abs(b)))


def check_close(name, got, ref, rtol, atol=0.0):
    """Raise unless |got − ref| <= atol + rtol·|ref| everywhere; return the
    largest absolute error."""
    import torch

    err = torch.abs(got - ref)
    over = float(torch.max(err - (atol + rtol * torch.abs(ref))))
    max_abs = float(torch.max(err))
    if over > 0.0 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max abs err {max_abs:.3e} exceeds "
                             f"rtol {rtol} / atol {atol}")
    return max_abs


def cuda_ms(fn, inner, reps=REPS, warmup=2):
    """Milliseconds per call of ``fn``: the median over ``reps`` runs, each
    ``inner`` back-to-back calls between two CUDA events, after ``warmup``
    calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write every measured number as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from tpinn_torch.history import History
    from tpinn_torch.kernels import build
    from tpinn_torch.kernels import mlp_bundle as mb

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    record = {}

    with phase("1 device and build"):
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"card: {smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")
        info = build.build()
        build.library()
        print(f"nvcc build: {info.seconds:.2f} s "
              f"({'compiled' if info.compiled else 'cached'}) -> "
              f"{os.path.relpath(info.path)}")
        for line in info.log.splitlines():
            if "Used" in line or "spill" in line:
                print("  ptxas:", line.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        record["card"] = smi
        record["build_s"] = info.seconds

    f64 = torch.float64
    w3 = (10.0, 1.0, 1.0)
    errs = {"ns_residual_bwd": 0.0, "ns_residual_fwd": 0.0}

    with phase("2 kernel 1 (ns_residual_bwd) vs plain, float64"):
        cases = [("steady n=1000", 2, 1000, None),
                 ("masked n=4099 n_valid=4000", 2, 4099, 4000),
                 ("unsteady n=1000", 3, 1000, None)]
        for name, d_in, n, n_valid in cases:
            params, x, physics, norm = problem(d_in, n, 1 + d_in, f64, dev)
            gbar = torch.tensor(w3, dtype=f64, device=dev)
            n_mean = n_valid or n
            dp, mses, loss = mb.ns_residual_bwd(params, x, physics, norm, gbar,
                                                n_valid, n_mean, with_loss=True)
            torch.cuda.synchronize()
            fl = [p.clone().requires_grad_(True) for p in flat(params)]
            pl = [{"kernel": fl[i], "bias": fl[i + 1]}
                  for i in range(0, len(fl), 2)]
            loss_p, mses_p = mb.ns_residual_weighted_obj_plain(
                pl, x, physics, norm, w3, n_valid, n_mean)
            grads_p = torch.autograd.grad(loss_p, fl)
            e_l = check_close(f"{name} loss", loss, loss_p.detach(), 1e-11)
            e_m = check_close(f"{name} mses", mses, mses_p, 1e-11)
            e_g = max(check_close(f"{name} grad {i}", g, gp, 1e-9, 1e-12)
                      for i, (g, gp) in enumerate(zip(flat(dp), grads_p)))
            dp2, mses2, loss2 = mb.ns_residual_bwd(params, x, physics, norm,
                                                   gbar, n_valid, n_mean,
                                                   with_loss=True)
            same = (torch.equal(loss, loss2) and torch.equal(mses, mses2)
                    and all(torch.equal(a, b)
                            for a, b in zip(flat(dp), flat(dp2))))
            if not same:
                raise AssertionError(f"{name}: repeat call not bit-identical")
            print(f"  {name}: loss rel {rel(loss, loss_p.detach()):.2e}, "
                  f"mses rel {rel(mses, mses_p):.2e}, grads max abs {e_g:.2e}, "
                  f"repeat bit-identical")
            if name.startswith("steady"):
                errs["ns_residual_bwd"] = max(e_l, e_m, e_g)
            # the float32 instantiation against float64
            p32 = [{k: t.float() for k, t in p.items()} for p in params]
            dp32, m32, l32 = mb.ns_residual_bwd(p32, x.float(), physics, norm,
                                                gbar.float(), n_valid, n_mean,
                                                with_loss=True)
            g_scale = max(float(torch.max(torch.abs(g))) for g in flat(dp))
            g_err = max(float(torch.max(torch.abs(a.double() - b)))
                        for a, b in zip(flat(dp32), flat(dp))) / g_scale
            if not all(bool(torch.isfinite(t).all()) for t in flat(dp32)):
                raise AssertionError(f"{name}: float32 grads not finite")
            print(f"  {name}: float32 vs float64: loss rel "
                  f"{rel(l32.double(), loss):.2e}, mses rel "
                  f"{rel(m32.double(), mses):.2e}, grads max abs / max|g| "
                  f"{g_err:.2e}")
            record[f"f32_err {name}"] = [rel(l32.double(), loss), g_err]

    with phase("3 kernel 2 (ns_residual_fwd) vs plain, float64"):
        for name, d_in, n, n_valid in cases:
            params, x, physics, norm = problem(d_in, n, 1 + d_in, f64, dev)
            n_mean = n_valid or n
            m2 = mb.ns_residual_fwd(params, x, physics, norm, n_valid, n_mean)
            m_p = mb.ns_residual_mse_plain(params, x, physics, norm, n_valid,
                                           n_mean)
            e = check_close(f"{name} fwd mses", m2, m_p, 1e-11)
            gbar = torch.tensor(w3, dtype=f64, device=dev)
            _, m1, _ = mb.ns_residual_bwd(params, x, physics, norm, gbar,
                                          n_valid, n_mean)
            check_close(f"{name} fwd vs bwd mses", m2, m1, 1e-12)
            # ns_residual_mse: kernel 2 forward, kernel 1 backward
            fl = [p.clone().requires_grad_(True) for p in flat(params)]
            pl = [{"kernel": fl[i], "bias": fl[i + 1]}
                  for i in range(0, len(fl), 2)]
            g_k = torch.autograd.grad(
                (gbar * mb.ns_residual_mse(pl, x, physics, norm, n_valid,
                                           n_mean)).sum(), fl)
            g_p = torch.autograd.grad(
                (gbar * mb.ns_residual_mse_plain(pl, x, physics, norm,
                                                 n_valid, n_mean)).sum(), fl)
            e_g = max(check_close(f"{name} mse grad {i}", a, b, 1e-9, 1e-12)
                      for i, (a, b) in enumerate(zip(g_k, g_p)))
            print(f"  {name}: mses rel {rel(m2, m_p):.2e}, bit-identical to "
                  f"kernel 1: {torch.equal(m2, m1)}, ns_residual_mse grads "
                  f"max abs {e_g:.2e}")
            if name.startswith("steady"):
                errs["ns_residual_fwd"] = e

    with phase("4 the slice: Poiseuille Adam round, 100 epochs, float64"):
        from tpinn_torch.cases import poiseuille_flow

        with tempfile.TemporaryDirectory() as td:
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv = poiseuille_flow.main(td, adam_epochs=100, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(mb.LAUNCHES)
            hist = History.load(os.path.join(drv.folder, "History_Loss.json"))
        print(f"  launches on the main path: {launches}; wall {wall:.2f} s "
              f"({1e3 * wall / 100:.2f} ms/epoch with logging)")
        if launches["ns_residual_bwd"] < 100 or launches["ns_residual_fwd"] < 1:
            raise AssertionError(f"main path missed a kernel: {launches}")
        logs = [hist.loss_global] + [e["log"] for e in hist.losses.values()] \
            + [e["log"] for e in hist.losses_test.values()]
        if not all(np.isfinite(v).all() for v in logs):
            raise AssertionError("non-finite logged loss")
        if not hist.loss_global[-1] < hist.loss_global[0]:
            raise AssertionError("loss did not fall")
        if hist.iters != list(range(0, 101, 10)):
            raise AssertionError(f"unexpected log iterations {hist.iters}")
        with tempfile.TemporaryDirectory() as td:
            ref = poiseuille_flow.main(td, adam_epochs=100, device="cpu")
        a = np.array(hist.loss_global)
        b = np.array(ref.pb.history.loss_global)
        dev_rel = float(np.max(np.abs(a - b) / np.abs(b)))
        print(f"  loss_global {a[0]:.6e} -> {a[-1]:.6e}; against the plain "
              f"versions on the CPU: max rel deviation {dev_rel:.2e}")
        if dev_rel > 1e-8:
            raise AssertionError("card and CPU histories disagree")
        record["slice"] = {"launches": launches, "wall_s": wall,
                           "loss_first": a[0], "loss_last": a[-1],
                           "cpu_rel_dev": dev_rel}

    with phase("5 times (CUDA events, median of 10 runs)"):
        times = {}
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            for n in SIZES:
                params, x, physics, norm = problem(2, n, 7, dtype, dev)
                gbar = torch.tensor(w3, dtype=dtype, device=dev)
                fl = [p.clone().requires_grad_(True) for p in flat(params)]
                pl = [{"kernel": fl[i], "bias": fl[i + 1]}
                      for i in range(0, len(fl), 2)]

                def plain_bwd():
                    loss, _ = mb.ns_residual_weighted_obj_plain(
                        pl, x, physics, norm, w3)
                    torch.autograd.grad(loss, fl)

                def plain_fwd():
                    with torch.no_grad():
                        mb.ns_residual_mse_plain(params, x, physics, norm)

                inner = 20 if n <= 10_000 else 1
                row = {
                    "bwd": cuda_ms(lambda: mb.ns_residual_bwd(
                        params, x, physics, norm, gbar, with_loss=True), inner),
                    "fwd": cuda_ms(lambda: mb.ns_residual_fwd(
                        params, x, physics, norm), inner),
                    "plain_bwd": cuda_ms(plain_bwd, inner),
                    "plain_fwd": cuda_ms(plain_fwd, inner),
                }
                widths = (2,) + WIDTHS + (3,)
                item = x.element_size()
                for k, bwd in (("bwd", True), ("fwd", False)):
                    ops = n * ns_flops_per_point(widths, 2, bwd)
                    nbytes = item * (n * 2 + sum((a + 1) * b for a, b in
                                                 zip(widths[:-1], widths[1:])))
                    if bwd:
                        nbytes += item * (3 + sum((a + 1) * b for a, b in
                                                  zip(widths[:-1], widths[1:])) + 4)
                    else:
                        nbytes += item * 3
                    t_ops = 1e3 * ops / PEAK_FLOPS[dname]
                    t_bytes = 1e3 * nbytes / PEAK_BYTES
                    row[f"{k}_bound"] = max(t_ops, t_bytes)
                    row[f"{k}_bound_by"] = ("operations" if t_ops >= t_bytes
                                            else "bytes")
                    row[f"{k}_flops_per_point"] = ops / n
                times[(dname, n)] = row
                print(f"  {dname} n={n}: bwd {row['bwd']:.4f} ms (bound "
                      f"{row['bwd_bound']:.4f}, plain {row['plain_bwd']:.4f}); "
                      f"fwd {row['fwd']:.4f} ms (bound {row['fwd_bound']:.4f}, "
                      f"plain {row['plain_fwd']:.4f})", flush=True)
                del params, x, fl, pl
                torch.cuda.empty_cache()
        record["times"] = {f"{d} {n}": r for (d, n), r in times.items()}

    main_row = times[("float64", 1000)]
    kernels = [
        {"name": "ns_residual_bwd", "route": "cuda",
         "source": "tpinn_torch/kernels/csrc/ns_residual.cu",
         "replaces": "tpinn/pallas/mlp_bundle.py:556",
         "launches": launches["ns_residual_bwd"],
         "max_abs_err": errs["ns_residual_bwd"],
         "ms": main_row["bwd"], "plain_ms": main_row["plain_bwd"],
         "bound_ms": main_row["bwd_bound"],
         "bound_by": main_row["bwd_bound_by"], "library_ms": None},
        {"name": "ns_residual_fwd", "route": "cuda",
         "source": "tpinn_torch/kernels/csrc/ns_residual.cu",
         "replaces": "tpinn/pallas/mlp_bundle.py:473",
         "launches": launches["ns_residual_fwd"],
         "max_abs_err": errs["ns_residual_fwd"],
         "ms": main_row["fwd"], "plain_ms": main_row["plain_fwd"],
         "bound_ms": main_row["fwd_bound"],
         "bound_by": main_row["fwd_bound_by"], "library_ms": None},
    ]
    total = time.perf_counter() - t_all
    print(f"total {total:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"kernels": kernels, **record, "total_s": total}, f,
                      indent=1, default=float)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
