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
5. times of the NS kernels and their plain versions at 1,000, 262,144 and
   1,048,576 points, and of the Poisson kernels at 200, 262,144 and
   1,048,576 points, in float32 and float64 (CUDA events around 20
   back-to-back calls at the small size and around single calls above,
   median of 10 such runs);
6. kernel 3 (poisson_residual_bwd) against its plain version in float64:
   widths 2-20-20-20-1 at n = 200, n = 4099 masked to n_valid = 4000, and
   normalization 3; loss and MSE at rtol 1e-11, dW/db at rtol 1e-9 /
   atol 1e-12; repeat calls bit-identical; the float32 error against
   float64;
7. kernel 4 (poisson_residual_fwd) at the same bars, its MSE bit-identical
   to kernel 3's, and poisson_residual_mse's gradient (kernel 4 forward,
   kernel 3 backward) against autograd;
8. the slice: both Poisson cases through tpinn_torch.cases.poisson.main
   (Adam 100 epochs, L-BFGS-B 100 iterations) and poisson_misto.main (Adam
   100, L-BFGS-B 50), float64, each with the launch counts read around it
   and held against the same case run through the plain versions on the
   CPU: the Adam round at 1e-8, the L-BFGS-B round's first 20 iterations at
   1e-8 and its final global loss at 5 % (L-BFGS-B amplifies rounding about
   tenfold per ten iterations, so later log points follow another
   trajectory; PERF.md section 2); the cost of one scipy function
   evaluation and of its two host/device copies;
9. kernel 5 (taylor_bundle, the per-point value, Jacobian and Hessian
   diagonal) against its plain version in float64: 2-32-32-32-3 at n =
   1000, 100 and 4099 (not a tile multiple), d_in = 3 (seven streams),
   2-20-20-20-1 (a scalar head), 3-20-20-20-3 with dim 1, 2 and 3 at a
   ragged n, widths 64 (3-64-64-3, 2-64-64-64-1), one-layer nets, and an
   8-layer width-64 net whose weights are streamed layer by layer; max
   |Δ| ≤ 1e-12·max|ref| per output; repeat calls bit-identical; the launch
   plan (points per tile, streaming, shared bytes) equal to its Python
   mirror (`mlp_bundle.bundle_plan`); the float32 instantiation's error
   against float64 (at most 1e-5 of max|ref|); back-to-back calls at two
   batch sizes, each bit-equal to the first at its size; the DMMA count of
   each float64 instance and no HMMA (TF32) in any, from `cuobjdump -sass`;
10. times of kernel 5 and its plain version at 100, 1,000, 262,144 and
   1,048,576 points, float32 and float64, as in phase 5, with the plan's
   tile and grid;
11. the slice: the Poiseuille Levenberg–Marquardt round (10 iterations
   after a 0-epoch Adam round, float64, the reference options) through
   tpinn_torch.cases.poiseuille_flow.main with TPINN_USE_PALLAS=1, the
   launch counts read around it (kernel 5 launches, kernels 1-4 do not),
   held against the same round through the plain versions on the CPU and
   against the round on the card with the opt-in off (kernel 5 then does
   not launch), all at the history bar 1e-8; the LM iteration's time split
   into residual evaluation, fast Gram, the JᵀJ download, the host eigh and
   the accept loop;
12. kernels 1-4 against their plain versions in float64 at widths that the
   tile layout pads (2-7-7-3, 2-24-24-3, 2-64-64-3, 3-16-16-3, 2-7-7-1,
   2-20-20-20-1, 2-64-64-1), d_in = 3, ragged last tiles and masked tails
   (n_valid < n), at the bars of phases 2 and 6; repeats bit-identical;
   kernel 2's / 4's MSEs bit-equal to kernel 1's / 3's; the launch plan
   (points per tile, shared bytes) equal to its Python mirror;
13. back-to-back calls of kernels 1 and 3 at two batch sizes (two grids) on
   one stream, each result bit-equal to the first call at its size: every
   launch's last block resets the ticket;
14. the device time per launch of kernels 1-5 under torch.profiler beside
   the event-timed call time, the device kernels one call launches (1 for
   each), at the main shapes and at 1,048,576 points;
15. the slice: the Poiseuille main path, Adam 100 epochs then the dense
   BFGS round ("jax-bfgs", 40 iterations), float64, through
   tpinn_torch.cases.poiseuille_flow.main, with the launch counts read
   around it (one kernel-1 launch per value and gradient, one kernel-2
   launch per logged evaluation), the plain variant, held against the same
   run on the CPU (every log through BFGS iteration 20 at 1e-8, the final
   global loss at 5 %); a repeat of the BFGS round from the same state
   bit-identical, with the host synchronisations it issues counted (torch's
   sync debug mode); the iteration split (direction, evaluations, H update)
   from a timed repeat, also bit-identical; the host scipy BFGS round
   ("scipy-parity", 20 iterations) per iteration beside it; a float32 round
   of 20 iterations, finite and descending, against float64;
16. the paired variant (TPINN_USE_PALLAS=0, every loss a residual vector),
   20 BFGS iterations on the card against the CPU at 1e-8;
17. the Poisson case's "jax-bfgs" round (Adam 100 + BFGS 20, kernels 3/4,
   one kernel-3 launch per evaluation) against the CPU at 1e-8;
18. the artifacts and an exact resume on the card: 20 BFGS iterations
   straight against 10, the run folder written (Model.json, the weights as
   Weights.npz where h5py is missing, History_Loss.json, checkpoint.pkl,
   Test_Options.txt), and 10 more in a new driver resuming it, every log
   bit-identical; ``checkpoint.load_experiment`` reproduces the model's
   outputs bit for bit;
19. the slice: the Poiseuille main path with the on-device L-BFGS round,
   Adam 100 epochs then L-BFGS ("jax", 100 iterations), float64, through
   tpinn_torch.cases.poiseuille_flow.main, with the launch counts read
   around it (one kernel-1 launch per line-search trial plus one for the
   first iteration, one kernel-2 launch per logged evaluation), held
   against the same run on the CPU (every log through L-BFGS iteration 20
   at 1e-8, the final global loss at 5 %); a repeat from the same state
   bit-identical, with its host synchronisations counted; the iteration
   split (direction, that is the two-loop recursion, and the line search's
   evaluations) from a timed repeat, also bit-identical; the ms per
   iteration beside phase 15's dense BFGS;
20. the slice at full width: colliding flow at its reference options
   (1000 PDE points, 100 per edge, 5 velocity and 1 pressure fitting
   points, 10,000 test points, 2-32-32-32-3, float64, NS kernels at
   convection 1/40) through tpinn_torch.cases.colliding_flow.main: Adam
   100 then the default "scipy" round (the dense BFGS, 20 iterations), on
   the card against the CPU (the history at 1e-8, the final global loss at
   5 %), with the launch counts read around it and the run folder written;
   then the Poisson case's L-BFGS branch (Adam 100 + L-BFGS 20, kernels
   3/4, one kernel-3 launch per evaluation) against the CPU at 1e-8;
21. the cosine-decay Adam second round ("adam", 100 epochs) on Poiseuille,
   card against CPU at 1e-8.

The line before the last is the kernels' JSON record (each kernel's
launches on every path that runs it, ``launches`` being its slice's main
path), the last line ``{"ok": true, "device": {...}}``.
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
POISSON_WIDTHS = (2, 20, 20, 20, 1)
POISSON_SIZES = (200, 262_144, 1_048_576)
REPS = 10
# L-BFGS-B rounds: the history of the first 20 iterations at the Adam bar;
# after that the two runs follow different trajectories (L-BFGS-B amplifies
# rounding about tenfold per ten iterations), so the whole round is held by
# its final global loss (PERF.md section 2)
SCIPY_HEAD_ITERS = 20
FINAL_LOSS_BAR = 0.05
BUNDLE_SIZES = (100, 1000, 262_144, 1_048_576)
LM_ITERS = 10
HISTORY_BAR = 1e-8
# the dense BFGS round (phase 15): 40 iterations on the card and the CPU, the
# history held at the bar over iterations 0-20 and by its final global loss
# after that (quasi-Newton rounds amplify rounding, PERF.md section 2)
BFGS_ITERS = 40
BFGS_HEAD_ITERS = 20
SCIPY_BFGS_ITERS = 20
F32_BFGS_ITERS = 20
PAIRED_ITERS = 20
RESUME_ITERS = 20
# the L-BFGS round (phase 19): 100 iterations, held like phase 15's round
LBFGS_ITERS = 100
LBFGS_HEAD_ITERS = 20
# colliding flow's dense BFGS round and Poisson's L-BFGS round (phase 20)
COLLIDING_ITERS = 20
POISSON_LBFGS_ITERS = 20
# the cosine-decay Adam second round (phase 21)
COSINE_EPOCHS = 100


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


def poisson_flops_per_point(widths, bwd):
    """Floating-point operations one point needs in the Poisson-residual
    kernels, counted like ``ns_flops_per_point``: the hidden layers carry
    all five streams (value, two gradient and two Hessian-diagonal streams);
    at the scalar head only the two Hessian-diagonal streams are needed,
    forward and backward (the other head cotangents are structural zeros),
    and the head bias gets no gradient."""
    d_in, S = 2, 5
    L = len(widths) - 1
    f = 0
    for l in range(L):
        wi, wo = widths[l], widths[l + 1]
        if l == L - 1:
            f += 2 * 2 * wi * wo
            continue
        f += (2 * wi * wo if l == 0 else 2 * S * wi * wo) + wo
        f += wo * (1 + 2 + 2 + d_in + 2 * (3 if l == 0 else 5))
    f += 5  # r = (h_x + h_y + f)·scale, r², the sum
    if not bwd:
        return f
    f += 3  # c = ḡ·(2/n)·r·scale
    for l in range(L - 1, -1, -1):
        wi, wo = widths[l], widths[l + 1]
        if l == L - 1:
            f += 2 * 2 * wi * wo * (2 if l > 0 else 1)
            continue
        f += wo * (6 + 1 + 3 * d_in + 2 * (7 if l > 0 else 5)
                   + d_in + 2 * 3 + 2)
        f += (3 * wi * wo if l == 0 else 2 * S * wi * wo) + wo
        if l > 0:
            f += 2 * S * wi * wo
    return f


def bundle_flops_per_point(widths, dim):
    """Floating-point operations one point needs in kernel 5: layer 0
    forms the value stream only (its tangent streams are rows of W0, its
    second-order streams zero); every later layer multiplies all 1 + 2·dim
    streams; per hidden neuron tanh, tanh' (2), a = −2·v·tanh' (2), dim
    tangent products and per second-order stream a·z_g·z_g + tanh'·z_h
    (4, 2 at layer 0 where z_h is zero)."""
    S = 1 + 2 * dim
    L = len(widths) - 1
    f = 0
    for l in range(L):
        wi, wo = widths[l], widths[l + 1]
        f += (2 * wi * wo if l == 0 else 2 * S * wi * wo) + wo
        if l < L - 1:
            f += wo * (1 + 2 + 2 + dim + dim * (2 if l == 0 else 4))
    return f


def sass_counts(lib_path):
    """{kernel-5 instance: {"DMMA": n, "HMMA": n}} from ``cuobjdump -sass``
    of the built library (instances named by their template arguments:
    Id / If for float64 / float32, then d_in and dim); None where the
    toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : \S*taylor_bundle_kernelI(\w)Li(\d)ELi(\d)E",
                      line)
        if m:
            name = f"I{m.group(1)} d_in {m.group(2)} dim {m.group(3)}"
            counts[name] = {"DMMA": 0, "HMMA": 0}
        elif "Function :" in line:
            name = None
        elif name is not None:
            for op in ("DMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def bundle_problem(widths, n, seed, dtype, device):
    """Seeded params of the given widths and points in (-1, 1)^d_in."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    params = random_params(rng, widths, dtype, device)
    x = torch.tensor(rng.uniform(-1.0, 1.0, (n, widths[0])), dtype=dtype,
                     device=device)
    return params, x


def poisson_problem(n, seed, dtype, device, widths=POISSON_WIDTHS):
    """Seeded params (2-20-20-20-1 by default), points in (0, 2π)² and the
    forcing."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    params = random_params(rng, widths, dtype, device)
    x = torch.tensor(rng.uniform(0.0, 2 * np.pi, (n, 2)), dtype=dtype,
                     device=device)
    f = 2.0 * torch.sin(x[:, 0]) * torch.sin(x[:, 1])
    return params, x, f


def bound(n_ops, n_bytes, dname):
    """(bound ms, what bounds it) from the operations and bytes of a call."""
    t_ops = 1e3 * n_ops / PEAK_FLOPS[dname]
    t_bytes = 1e3 * n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rel_dev(h_ref, h, sel):
    """Largest relative deviation of every logged value of two histories
    at the log-point indices ``sel``."""
    import numpy as np

    series = [(h_ref.loss_global, h.loss_global)]
    for group in ("losses", "losses_test"):
        ref, got = getattr(h_ref, group), getattr(h, group)
        series += [(ref[k]["log"], got[k]["log"]) for k in ref]
    return max(float(np.max(np.abs(np.array(b)[sel] - np.array(a)[sel])
                            / np.abs(np.array(a)[sel]))) for a, b in series)


def leaves_of(params):
    """Fresh leaf copies of params that require grad, and their flat list."""
    fl = [p.clone().requires_grad_(True) for p in flat(params)]
    return [{"kernel": fl[i], "bias": fl[i + 1]}
            for i in range(0, len(fl), 2)], fl


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


def problem(d_in, n, seed, dtype, device, hidden=WIDTHS):
    """A seeded batch, params and physics: the Poiseuille coefficients and
    normalization for the steady layout, unit coefficients unsteady."""
    import numpy as np
    import torch

    from tpinn_torch.geometry import Normalization
    from tpinn_torch.oracles import analytic
    from tpinn_torch.pipeline import NSPhysics

    rng = np.random.default_rng(seed)
    widths = (d_in,) + tuple(hidden) + (3,)
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


def device_profile(fn, calls=20):
    """(device ms per launch, device kernels per call, kernel names) of
    ``fn`` under torch.profiler (CUDA activity, after a warm-up call), as
    tpinn_torch/profiling.py reads a trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then drops kernel records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(ks) >= calls:
            break
    if not ks:
        raise AssertionError("the profiler saw no device kernel")
    return (sum(e.time_range.elapsed_us() for e in ks) / len(ks) / 1e3,
            len(ks) / calls, sorted({e.name[:80] for e in ks}))


def host_ms(fn, reps=50, warmup=3):
    """Milliseconds per call of ``fn`` on the host clock, the median over
    ``reps`` calls, each ended by a device synchronisation."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
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
    # phases 1-10 run the default routing; phase 11 sets the opt-in itself
    os.environ.pop("TPINN_USE_PALLAS", None)
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
        print(f"nvcc build: {info.seconds:.2f} s, all sources at once "
              f"({'compiled' if info.compiled else 'cached'}) -> "
              + ", ".join(os.path.relpath(p) for p in info.paths.values()))
        for source in build.SOURCES:
            build.library(source)
        for line in info.log.splitlines():
            if "Used" in line or "spill" in line:
                print("  ptxas:", line.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        record["card"] = smi
        record["build_s"] = info.seconds

    f64 = torch.float64
    w3 = (10.0, 1.0, 1.0)
    errs = {k: 0.0 for k in mb.LAUNCHES}

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
            drv = poiseuille_flow.main(td, adam_epochs=100, device="cuda",
                                       second_round="none")
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
            ref = poiseuille_flow.main(td, adam_epochs=100, device="cpu",
                                       second_round="none")
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
                pl, fl = leaves_of(params)

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
                n_par = sum((a + 1) * b for a, b in zip(widths[:-1], widths[1:]))
                for k, bwd in (("bwd", True), ("fwd", False)):
                    ops = n * ns_flops_per_point(widths, 2, bwd)
                    nbytes = item * (n * 2 + n_par + 3 + (n_par + 4 if bwd else 0))
                    row[f"{k}_bound"], row[f"{k}_bound_by"] = bound(
                        ops, nbytes, dname)
                    row[f"{k}_flops_per_point"] = ops / n
                times[("ns", dname, n)] = row
                print(f"  NS {dname} n={n}: bwd {row['bwd']:.4f} ms (bound "
                      f"{row['bwd_bound']:.4f}, plain {row['plain_bwd']:.4f}); "
                      f"fwd {row['fwd']:.4f} ms (bound {row['fwd_bound']:.4f}, "
                      f"plain {row['plain_fwd']:.4f})", flush=True)
                del params, x, fl, pl
                torch.cuda.empty_cache()
            for n in POISSON_SIZES:
                params, x, f = poisson_problem(n, 7, dtype, dev)
                gbar = torch.tensor([2.0], dtype=dtype, device=dev)
                pl, fl = leaves_of(params)

                def plain_bwd():
                    loss, _ = mb.poisson_residual_weighted_obj_plain(
                        pl, x, f, 2.0)
                    torch.autograd.grad(loss, fl, materialize_grads=True)

                def plain_fwd():
                    with torch.no_grad():
                        mb.poisson_residual_mse_plain(params, x, f)

                inner = 20 if n <= 10_000 else 1
                row = {
                    "bwd": cuda_ms(lambda: mb.poisson_residual_bwd(
                        params, x, f, gbar, with_loss=True), inner),
                    "fwd": cuda_ms(lambda: mb.poisson_residual_fwd(
                        params, x, f), inner),
                    "plain_bwd": cuda_ms(plain_bwd, inner),
                    "plain_fwd": cuda_ms(plain_fwd, inner),
                }
                item = x.element_size()
                n_par = sum((a + 1) * b for a, b in
                            zip(POISSON_WIDTHS[:-1], POISSON_WIDTHS[1:]))
                for k, bwd in (("bwd", True), ("fwd", False)):
                    ops = n * poisson_flops_per_point(POISSON_WIDTHS, bwd)
                    nbytes = item * (n * 3 + n_par + 1 + (n_par + 1 if bwd else 0))
                    row[f"{k}_bound"], row[f"{k}_bound_by"] = bound(
                        ops, nbytes, dname)
                    row[f"{k}_flops_per_point"] = ops / n
                times[("poisson", dname, n)] = row
                print(f"  Poisson {dname} n={n}: bwd {row['bwd']:.4f} ms "
                      f"(bound {row['bwd_bound']:.5f}, plain "
                      f"{row['plain_bwd']:.4f}); fwd {row['fwd']:.4f} ms "
                      f"(bound {row['fwd_bound']:.5f}, plain "
                      f"{row['plain_fwd']:.4f})", flush=True)
                del params, x, f, fl, pl
                torch.cuda.empty_cache()
        record["times"] = {" ".join(map(str, k)): r for k, r in times.items()}

    with phase("6 kernel 3 (poisson_residual_bwd) vs plain, float64"):
        p_cases = [("n=200", 200, None, 1.0),
                   ("masked n=4099 n_valid=4000", 4099, 4000, 1.0),
                   ("n=200 normalization 3", 200, None, 3.0)]
        for name, n, n_valid, norm_c in p_cases:
            params, x, f = poisson_problem(n, 11, f64, dev)
            gbar = torch.tensor([2.0], dtype=f64, device=dev)
            dp, mse, loss = mb.poisson_residual_bwd(
                params, x, f, gbar, norm_c, n_valid, n_valid, with_loss=True)
            torch.cuda.synchronize()
            pl, fl = leaves_of(params)
            loss_p, mse_p = mb.poisson_residual_weighted_obj_plain(
                pl, x, f, 2.0, norm_c, n_valid, n_valid)
            grads_p = torch.autograd.grad(loss_p, fl, materialize_grads=True)
            e_l = check_close(f"{name} loss", loss, loss_p.detach(), 1e-11)
            e_m = check_close(f"{name} mse", mse, mse_p, 1e-11)
            e_g = max(check_close(f"{name} grad {i}", g, gp, 1e-9, 1e-12)
                      for i, (g, gp) in enumerate(zip(flat(dp), grads_p)))
            dp2, mse2, loss2 = mb.poisson_residual_bwd(
                params, x, f, gbar, norm_c, n_valid, n_valid, with_loss=True)
            if not (torch.equal(loss, loss2) and torch.equal(mse, mse2)
                    and all(torch.equal(a, b)
                            for a, b in zip(flat(dp), flat(dp2)))):
                raise AssertionError(f"{name}: repeat call not bit-identical")
            print(f"  {name}: loss rel {rel(loss, loss_p.detach()):.2e}, "
                  f"mse rel {rel(mse, mse_p):.2e}, grads max abs {e_g:.2e}, "
                  f"repeat bit-identical")
            if name == "n=200":
                errs["poisson_residual_bwd"] = max(e_l, e_m, e_g)
            p32 = [{k: t.float() for k, t in p.items()} for p in params]
            dp32, m32, l32 = mb.poisson_residual_bwd(
                p32, x.float(), f.float(), gbar.float(), norm_c, n_valid,
                n_valid, with_loss=True)
            g_scale = max(float(torch.max(torch.abs(g))) for g in flat(dp))
            g_err = max(float(torch.max(torch.abs(a.double() - b)))
                        for a, b in zip(flat(dp32), flat(dp))) / g_scale
            if not all(bool(torch.isfinite(t).all()) for t in flat(dp32)):
                raise AssertionError(f"{name}: float32 grads not finite")
            print(f"  {name}: float32 vs float64: loss rel "
                  f"{rel(l32.double(), loss):.2e}, grads max abs / max|g| "
                  f"{g_err:.2e}")
            record[f"f32_err poisson {name}"] = [rel(l32.double(), loss), g_err]

    with phase("7 kernel 4 (poisson_residual_fwd) vs plain, float64"):
        for name, n, n_valid, norm_c in p_cases:
            params, x, f = poisson_problem(n, 11, f64, dev)
            m4 = mb.poisson_residual_fwd(params, x, f, norm_c, n_valid, n_valid)
            m_p = mb.poisson_residual_mse_plain(params, x, f, norm_c, n_valid,
                                                n_valid)
            e = check_close(f"{name} fwd mse", m4, m_p, 1e-11)
            gbar = torch.tensor([2.0], dtype=f64, device=dev)
            _, m3, _ = mb.poisson_residual_bwd(params, x, f, gbar, norm_c,
                                               n_valid, n_valid)
            if not torch.equal(m4, m3):
                raise AssertionError(f"{name}: kernel 4's MSE is not kernel "
                                     f"3's bit for bit ({float(m4)!r} vs "
                                     f"{float(m3)!r})")
            pl, fl = leaves_of(params)
            g_k = torch.autograd.grad(
                0.5 * mb.poisson_residual_mse(pl, x, f, norm_c, n_valid,
                                              n_valid), fl)
            g_p = torch.autograd.grad(
                0.5 * mb.poisson_residual_mse_plain(pl, x, f, norm_c, n_valid,
                                                    n_valid), fl,
                materialize_grads=True)
            e_g = max(check_close(f"{name} mse grad {i}", a, b, 1e-9, 1e-12)
                      for i, (a, b) in enumerate(zip(g_k, g_p)))
            print(f"  {name}: mse rel {rel(m4, m_p):.2e}, bit-identical to "
                  f"kernel 3, poisson_residual_mse grads max abs {e_g:.2e}")
            if name == "n=200":
                errs["poisson_residual_fwd"] = e

    with phase("8 the slice: Poisson cases, Adam 100 + L-BFGS-B, float64"):
        from tpinn_torch.cases import poisson, poisson_misto

        slices = {}
        for case, epochs in ((poisson, 100), (poisson_misto, 50)):
            name = case.__name__.rsplit(".", 1)[1]
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pb, model = case.main(epochs, out_dir=td, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = dict(mb.LAUNCHES)
                written = sorted(os.listdir(os.path.join(td, "Images")))
            h = pb.history
            n_bwd, n_fwd = (counts["poisson_residual_bwd"],
                            counts["poisson_residual_fwd"])
            print(f"  {name}: launches {counts}; {n_bwd - 100} scipy "
                  f"function evaluations; wall {wall:.2f} s (Adam "
                  f"{1e3 * h.wall_times[0] / 100:.2f} ms/epoch, L-BFGS-B "
                  f"{1e3 * h.wall_times[1] / max(n_bwd - 100, 1):.2f} ms per "
                  f"evaluation, logging included); wrote {written}")
            if n_bwd <= 100 or n_fwd < 1 or counts["ns_residual_bwd"]:
                raise AssertionError(f"{name}: main path missed a kernel: "
                                     f"{counts}")
            logs = [h.loss_global] + [e["log"] for e in h.losses.values()] \
                + [e["log"] for e in h.losses_test.values()]
            if not all(np.isfinite(v).all() for v in logs):
                raise AssertionError(f"{name}: non-finite logged loss")
            if not h.loss_global[-1] < h.loss_global[0]:
                raise AssertionError(f"{name}: loss did not fall")
            if h.round_names != ["keras_Adam", "scipy_L-BFGS-B"]:
                raise AssertionError(f"{name}: rounds {h.round_names}")
            with tempfile.TemporaryDirectory() as td:
                ref, _ = case.main(epochs, out_dir=td, device="cpu")
            hr = ref.history
            if hr.iters != h.iters:
                raise AssertionError(f"{name}: card and CPU log at other "
                                     f"iterations ({h.iters} / {hr.iters})")
            adam = [i for i, r in enumerate(hr.rounds_idx) if r == 1]
            head = [i for i, r in enumerate(hr.rounds_idx)
                    if r == 2 and hr.iter_round[i] <= SCIPY_HEAD_ITERS]
            scipy_all = [i for i, r in enumerate(hr.rounds_idx) if r == 2]
            d_adam, d_head, d_all = (rel_dev(hr, h, adam),
                                     rel_dev(hr, h, head),
                                     rel_dev(hr, h, scipy_all))
            d_final = abs(h.loss_global[-1] / hr.loss_global[-1] - 1.0)
            test_mse = h.losses_test["fit"]["log"][-1]
            print(f"  {name}: against the plain versions on the CPU: Adam "
                  f"{d_adam:.2e}, L-BFGS-B first {SCIPY_HEAD_ITERS} "
                  f"iterations {d_head:.2e}, whole round ({h.iter_round[-1]} "
                  f"iterations) {d_all:.2e}, final global loss "
                  f"{h.loss_global[-1]:.6e} (CPU {hr.loss_global[-1]:.6e}, "
                  f"{d_final:.2e} apart); final test MSE {test_mse:.6e} "
                  f"(CPU {hr.losses_test['fit']['log'][-1]:.6e})")
            if d_adam > 1e-8 or d_head > 1e-8 or d_final > FINAL_LOSS_BAR:
                raise AssertionError(f"{name}: card and CPU histories "
                                     "disagree")
            slices[name] = {"launches": counts, "wall_s": wall,
                            "adam_s": h.wall_times[0],
                            "scipy_s": h.wall_times[1],
                            "scipy_evals": n_bwd - 100,
                            "scipy_iters": h.iter_round[-1],
                            "dev_adam": d_adam, "dev_scipy_head": d_head,
                            "dev_scipy_round": d_all,
                            "final_loss_rel": d_final, "test_mse": test_mse,
                            "loss_first": h.loss_global[0],
                            "loss_last": h.loss_global[-1]}
            if name == "poisson":
                p_launches = counts
                # one scipy function evaluation, and its two copies alone
                vec = pb.get_vector()
                eval_ms = host_ms(lambda: pb.value_and_grad_vector(vec))
                h2d_ms = host_ms(lambda: pb.set_vector(vec))
                grad = torch.zeros(vec.size + 1, dtype=f64, device=dev)
                d2h_ms = host_ms(lambda: grad.cpu())
                print(f"  poisson: one scipy evaluation {eval_ms:.3f} ms "
                      f"(host clock, median of 50), of which the parameter "
                      f"upload {h2d_ms:.3f} ms and the loss+gradient "
                      f"download {d2h_ms:.3f} ms ({vec.size} float64 values)")
                slices[name].update(eval_ms=eval_ms, h2d_ms=h2d_ms,
                                    d2h_ms=d2h_ms)
        record["poisson_slice"] = slices

    with phase("9 kernel 5 (taylor_bundle) vs plain, float64"):
        main_w = (2,) + WIDTHS + (3,)
        b_cases = [("2-32-32-32-3 n=1000", main_w, 1000, None),
                   ("2-32-32-32-3 n=100", main_w, 100, None),
                   ("2-32-32-32-3 n=4099", main_w, 4099, None),
                   ("3-32-32-32-3 n=1000", (3,) + WIDTHS + (3,), 1000, None),
                   ("2-20-20-20-1 n=1000", POISSON_WIDTHS, 1000, None),
                   ("3-20-20-20-3 n=1001 dim=1", (3, 20, 20, 20, 3), 1001, 1),
                   ("3-20-20-20-3 n=1001 dim=2", (3, 20, 20, 20, 3), 1001, 2),
                   ("3-20-20-20-3 n=1001 dim=3", (3, 20, 20, 20, 3), 1001, 3),
                   ("3-64-64-3 n=777", (3, 64, 64, 3), 777, None),
                   ("2-64-64-64-1 n=4099", (2, 64, 64, 64, 1), 4099, None),
                   ("2-3 n=999 (one layer)", (2, 3), 999, None),
                   ("3-1 n=1003 dim=2 (one layer)", (3, 1), 1003, 2),
                   ("3-64x7-3 n=333 (streamed weights)",
                    (3,) + (64,) * 7 + (3,), 333, None)]
        for name, widths, n, dim in b_cases:
            params, x = bundle_problem(widths, n, 21, f64, dev)
            got = mb.mlp_taylor_bundle(params, x, dim)
            torch.cuda.synchronize()
            ref = mb.mlp_taylor_bundle_plain(params, x, dim)
            errs_b = []
            for part, a, b in zip(("value", "jac", "hdiag"), got, ref):
                if a.shape != b.shape:
                    raise AssertionError(f"{name} {part}: shape {a.shape} "
                                         f"!= {b.shape}")
                scale = float(torch.max(torch.abs(b)))
                e = float(torch.max(torch.abs(a - b)))
                if not e <= 1e-12 * scale:
                    raise AssertionError(f"{name} {part}: max abs err "
                                         f"{e:.3e} above 1e-12 x {scale:.3e}")
                errs_b.append((part, e, e / scale if scale else 0.0))
            again = mb.mlp_taylor_bundle(params, x, dim)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: repeat call not bit-identical")
            n_cols = widths[0] if dim is None else dim
            plan = mb._PLANS[("taylor_bundle", 0, f64, widths, n_cols, n)]
            mirror = mb.bundle_plan(widths, widths[0], n_cols, 8)
            if (plan.P, bool(plan.streamed), plan.smem) != mirror:
                raise AssertionError(f"{name}: plan (P, streamed, smem) "
                                     f"{(plan.P, plan.streamed, plan.smem)} "
                                     f"!= mirror {mirror}")
            p32 = [{k: t.float() for k, t in p.items()} for p in params]
            got32 = mb.mlp_taylor_bundle(p32, x.float(), dim)
            e32 = max(float(torch.max(torch.abs(a.double() - b)))
                      / max(float(torch.max(torch.abs(b))), 1e-300)
                      for a, b in zip(got32, got))
            if not e32 <= 1e-5:
                raise AssertionError(f"{name}: float32 vs float64 {e32:.2e}")
            print(f"  {name}: P {plan.P}, G {plan.G}, {plan.smem} B"
                  f"{', weights streamed' if plan.streamed else ''}; " + ", ".join(
                f"{p} max abs {e:.2e} (rel to max {r:.2e})"
                for p, e, r in errs_b)
                + f"; repeat bit-identical; float32 vs float64 max abs / "
                f"max|ref| {e32:.2e}")
            record[f"bundle {name}"] = {"errs": errs_b, "f32_err": e32,
                                        "P": plan.P, "G": plan.G,
                                        "streamed": plan.streamed}
            if name == "2-32-32-32-3 n=1000":
                errs["taylor_bundle"] = max(e for _, e, _ in errs_b)
        # back-to-back calls at two batch sizes (two grids) on one stream
        b_in = {n: bundle_problem(main_w, n, 25, f64, dev)
                for n in (1000, 50_000)}
        first = {}
        for _ in range(3):
            for n, (params, x) in b_in.items():
                got = mb.mlp_taylor_bundle(params, x)
                ref_ = first.setdefault(n, got)
                if not all(torch.equal(a, b) for a, b in zip(got, ref_)):
                    raise AssertionError(f"kernel 5 at n={n}: a later call "
                                         "differs")
        for n, (params, x) in b_in.items():
            for a, b in zip(first[n], mb.mlp_taylor_bundle_plain(params, x)):
                if not float(torch.max(torch.abs(a - b))) <= \
                        1e-12 * float(torch.max(torch.abs(b))):
                    raise AssertionError(f"kernel 5 at n={n}: off the plain "
                                         "version")
        print("  kernel 5 alternating n = 1000 / 50,000, three rounds: every "
              "call bit-equal to the first at its size, which matches the "
              "plain version")
        # what the compiler made of the f64 and f32 instances
        sass = sass_counts(info.paths["taylor_bundle.cu"])
        print(f"  cuobjdump -sass: {sass}")
        if sass is not None:
            if any(v["DMMA"] == 0 for k, v in sass.items() if "Id" in k):
                raise AssertionError(f"an f64 instance issues no DMMA: {sass}")
            if any(v["HMMA"] for v in sass.values()):
                raise AssertionError(f"an instance issues HMMA (TF32): {sass}")
        record["bundle_sass"] = sass

    with phase("10 kernel 5 times (CUDA events, median of 10 runs)"):
        widths = (2,) + WIDTHS + (3,)
        n_par = sum((a + 1) * b for a, b in zip(widths[:-1], widths[1:]))
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            for n in BUNDLE_SIZES:
                params, x = bundle_problem(widths, n, 7, dtype, dev)

                def plain():
                    with torch.no_grad():
                        mb.mlp_taylor_bundle_plain(params, x)

                inner = 20 if n <= 10_000 else 1
                row = {"kernel": cuda_ms(lambda: mb.mlp_taylor_bundle(
                           params, x), inner),
                       "plain": cuda_ms(plain, inner)}
                item = x.element_size()
                ops = n * bundle_flops_per_point(widths, 2)
                nbytes = item * (n * 2 + n_par + n * 3 * 5)
                row["bound"], row["bound_by"] = bound(ops, nbytes, dname)
                row["ops_ms"] = 1e3 * ops / PEAK_FLOPS[dname]
                row["bytes_ms"] = 1e3 * nbytes / PEAK_BYTES
                row["flops_per_point"] = ops / n
                plan = mb._PLANS[("taylor_bundle", 0, dtype, widths, 2, n)]
                row["P"], row["G"] = plan.P, plan.G
                times[("bundle", dname, n)] = row
                print(f"  kernel 5 {dname} n={n} (P {plan.P}, G {plan.G}): "
                      f"{row['kernel']:.4f} ms "
                      f"(bound {row['bound']:.5f} by {row['bound_by']}: "
                      f"operations {row['ops_ms']:.5f}, bytes "
                      f"{row['bytes_ms']:.5f}; plain {row['plain']:.4f})",
                      flush=True)
                del params, x
                torch.cuda.empty_cache()
        record["times"].update({" ".join(map(str, k)): r
                                for k, r in times.items()
                                if k[0] == "bundle"})

    with phase("11 the slice: Poiseuille LM round under TPINN_USE_PALLAS=1"):
        from tpinn_torch.cases import poiseuille_flow

        def lm_round(device, opt_in):
            if opt_in:
                os.environ["TPINN_USE_PALLAS"] = "1"
            try:
                with tempfile.TemporaryDirectory() as td:
                    mb.reset_launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    drv = poiseuille_flow.main(
                        td, adam_epochs=0, second_round="lm",
                        epochs=LM_ITERS, device=device)
                    torch.cuda.synchronize()
                    return (drv.pb, time.perf_counter() - t0,
                            dict(mb.LAUNCHES))
            finally:
                os.environ.pop("TPINN_USE_PALLAS", None)

        lm_pb, lm_wall, lm_launches = lm_round("cuda", True)
        h = lm_pb.history
        n_iters = len(lm_pb.lm_times)
        print(f"  launches on the main path: {lm_launches}; {n_iters} LM "
              f"iterations, wall {lm_wall:.2f} s")
        others = {k: v for k, v in lm_launches.items() if k != "taylor_bundle"}
        if lm_launches["taylor_bundle"] < 1 or any(others.values()):
            raise AssertionError(f"main path missed kernel 5 or ran another "
                                 f"kernel: {lm_launches}")
        if lm_launches["taylor_bundle"] % 3:
            raise AssertionError("kernel 5 launched other than three times "
                                 "(PDE bundle + two outflow bundles) per "
                                 f"residual evaluation: {lm_launches}")
        logs = [h.loss_global] + [e["log"] for e in h.losses.values()] \
            + [e["log"] for e in h.losses_test.values()]
        if not all(np.isfinite(v).all() for v in logs):
            raise AssertionError("non-finite logged loss")
        if h.round_names != ["keras_Adam", "jax_LM"]:
            raise AssertionError(f"rounds {h.round_names}")
        if not h.loss_global[-1] < 0.1 * h.loss_global[0]:
            raise AssertionError("LM did not reduce the loss tenfold")
        cpu_pb, cpu_wall, _ = lm_round("cpu", True)
        off_pb, off_wall, off_launches = lm_round("cuda", False)
        if off_launches["taylor_bundle"]:
            raise AssertionError(f"kernel 5 launched with the opt-in off: "
                                 f"{off_launches}")
        devs = {}
        for name, other in (("cpu", cpu_pb), ("opt-in off", off_pb)):
            if other.history.iters != h.iters:
                raise AssertionError(f"{name}: logs at other iterations "
                                     f"({other.history.iters} / {h.iters})")
            devs[name] = rel_dev(other.history, h,
                                 list(range(len(h.iters))))
        print(f"  loss_global {h.loss_global[0]:.6e} -> "
              f"{h.loss_global[-1]:.6e}; max rel deviation of every log "
              f"against the plain versions on the CPU {devs['cpu']:.2e} "
              f"(CPU wall {cpu_wall:.2f} s), against the card with the "
              f"opt-in off {devs['opt-in off']:.2e} (wall {off_wall:.2f} s)")
        if max(devs.values()) > HISTORY_BAR:
            raise AssertionError(f"LM histories disagree: {devs}")
        split = {}
        for name, pb_ in (("opt-in", lm_pb), ("opt-in off", off_pb),
                          ("cpu", cpu_pb)):
            parts = sorted({k for t in pb_.lm_times for k in t})
            later = pb_.lm_times[1:] or pb_.lm_times
            split[name] = {
                "first": pb_.lm_times[0],
                "median": {k: float(np.median([t.get(k, 0.0)
                                               for t in later]))
                           for k in parts}}
            med = split[name]["median"]
            print(f"  LM iteration ({name}), median of iterations 2-"
                  f"{len(pb_.lm_times)}, ms: " + ", ".join(
                      f"{k} {1e3 * med[k]:.2f}" for k in
                      ("residuals", "gram", "download", "eigh", "accept",
                       "log") if k in med)
                  + f"; first iteration {1e3 * sum(split[name]['first'].values()):.1f}")
        record["lm_slice"] = {"launches": lm_launches, "wall_s": lm_wall,
                              "cpu_wall_s": cpu_wall,
                              "off_wall_s": off_wall, "devs": devs,
                              "loss_first": h.loss_global[0],
                              "loss_last": h.loss_global[-1],
                              "split": split}

    with phase("12 kernels 1-4 at padded widths, d_in 3, ragged and masked"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiles = {}

        def check_plan(kind, widths, d_in, n_sq, x_extra, n_eff, n_mean):
            plan = mb._PLANS[(kind, 0, f64, tuple(widths), n_eff, n_mean,
                              True)]
            P = mb.plan_points(widths, d_in, n_sq, x_extra, 8, n_eff, sms)
            acc = mb._tile_fits(widths, d_in, n_sq, x_extra, 8, P, True)
            smem = 8 * mb.smem_elems(widths, d_in, P, True, n_sq, x_extra, acc)
            if (plan.P, plan.smem) != (P, smem):
                raise AssertionError(f"{kind} {widths}: plan (P, smem) "
                                     f"{(plan.P, plan.smem)} != mirror "
                                     f"{(P, smem)}")
            return plan

        for widths, n, n_valid in (((2, 7, 7, 3), 1000, None),
                                   ((2, 24, 24, 3), 1003, 997),
                                   ((2, 64, 64, 3), 4099, 4000),
                                   ((3, 16, 16, 3), 777, None),
                                   ((3,) + WIDTHS + (3,), 1001, 995)):
            name = "-".join(map(str, widths)) + f" n={n} n_valid={n_valid}"
            params, x, physics, norm = problem(widths[0], n, 31, f64, dev,
                                               widths[1:-1])
            gbar = torch.tensor(w3, dtype=f64, device=dev)
            n_mean = n_valid or n
            dp, mses, loss = mb.ns_residual_bwd(params, x, physics, norm, gbar,
                                                n_valid, n_mean, with_loss=True)
            pl, fl = leaves_of(params)
            loss_p, mses_p = mb.ns_residual_weighted_obj_plain(
                pl, x, physics, norm, w3, n_valid, n_mean)
            grads_p = torch.autograd.grad(loss_p, fl)
            e = max(check_close(f"{name} loss", loss, loss_p.detach(), 1e-11),
                    check_close(f"{name} mses", mses, mses_p, 1e-11),
                    *[check_close(f"{name} grad {i}", g, gp, 1e-9, 1e-12)
                      for i, (g, gp) in enumerate(zip(flat(dp), grads_p))])
            dp2, mses2, loss2 = mb.ns_residual_bwd(params, x, physics, norm,
                                                   gbar, n_valid, n_mean,
                                                   with_loss=True)
            m2 = mb.ns_residual_fwd(params, x, physics, norm, n_valid, n_mean)
            if not (torch.equal(loss, loss2) and torch.equal(mses, mses2)
                    and all(torch.equal(a, b)
                            for a, b in zip(flat(dp), flat(dp2)))):
                raise AssertionError(f"NS {name}: repeat not bit-identical")
            if not torch.equal(m2, mses):
                raise AssertionError(f"NS {name}: kernel 2's MSEs are not "
                                     "kernel 1's bit for bit")
            plan = check_plan("ns_residual", widths, widths[0], 3, 0,
                              n_valid or n, n_mean)
            print(f"  NS {name}: P {plan.P}, G {plan.G}, {plan.smem} B; max "
                  f"abs err {e:.2e}; repeat bit-identical; kernel 2 = "
                  f"kernel 1 bit for bit")
            tiles[f"ns {name}"] = {"max_abs_err": e, "P": plan.P, "G": plan.G}
        for widths, n, n_valid in (((2, 7, 7, 1), 1000, None),
                                   (POISSON_WIDTHS, 203, 197),
                                   ((2, 64, 64, 1), 4099, 4000)):
            name = "-".join(map(str, widths)) + f" n={n} n_valid={n_valid}"
            params, x, f = poisson_problem(n, 33, f64, dev, widths)
            gbar = torch.tensor([2.0], dtype=f64, device=dev)
            dp, mse, loss = mb.poisson_residual_bwd(
                params, x, f, gbar, 1.5, n_valid, n_valid, with_loss=True)
            pl, fl = leaves_of(params)
            loss_p, mse_p = mb.poisson_residual_weighted_obj_plain(
                pl, x, f, 2.0, 1.5, n_valid, n_valid)
            grads_p = torch.autograd.grad(loss_p, fl, materialize_grads=True)
            e = max(check_close(f"{name} loss", loss, loss_p.detach(), 1e-11),
                    check_close(f"{name} mse", mse, mse_p, 1e-11),
                    *[check_close(f"{name} grad {i}", g, gp, 1e-9, 1e-12)
                      for i, (g, gp) in enumerate(zip(flat(dp), grads_p))])
            dp2, mse2, loss2 = mb.poisson_residual_bwd(
                params, x, f, gbar, 1.5, n_valid, n_valid, with_loss=True)
            m4 = mb.poisson_residual_fwd(params, x, f, 1.5, n_valid, n_valid)
            if not (torch.equal(loss, loss2) and torch.equal(mse, mse2)
                    and all(torch.equal(a, b)
                            for a, b in zip(flat(dp), flat(dp2)))):
                raise AssertionError(f"Poisson {name}: repeat not "
                                     "bit-identical")
            if not torch.equal(m4, mse):
                raise AssertionError(f"Poisson {name}: kernel 4's MSE is not "
                                     "kernel 3's bit for bit")
            plan = check_plan("poisson_residual", widths, 2, 1, 1,
                              n_valid or n, n_valid or n)
            print(f"  Poisson {name}: P {plan.P}, G {plan.G}, {plan.smem} B; "
                  f"max abs err {e:.2e}; repeat bit-identical; kernel 4 = "
                  f"kernel 3 bit for bit")
            tiles[f"poisson {name}"] = {"max_abs_err": e, "P": plan.P,
                                        "G": plan.G}
        record["tiles"] = tiles

    with phase("13 back-to-back calls at two batch sizes (ticket reset)"):
        gbar3 = torch.tensor(w3, dtype=f64, device=dev)
        gbar1 = torch.tensor([2.0], dtype=f64, device=dev)
        ns_in = {n: problem(2, n, 41, f64, dev) for n in (1000, 50_000)}
        p_in = {n: poisson_problem(n, 43, f64, dev) for n in (200, 50_000)}
        first = {}
        for _ in range(3):
            for n, (params, x, physics, norm) in ns_in.items():
                got = mb.ns_residual_bwd(params, x, physics, norm, gbar3,
                                         with_loss=True)
                ref_ = first.setdefault(("ns", n), got)
                if not (torch.equal(got[1], ref_[1])
                        and torch.equal(got[2], ref_[2])):
                    raise AssertionError(f"kernel 1 at n={n}: a later call "
                                         "differs")
            for n, (params, x, f) in p_in.items():
                got = mb.poisson_residual_bwd(params, x, f, gbar1,
                                              with_loss=True)
                ref_ = first.setdefault(("poisson", n), got)
                if not (torch.equal(got[1], ref_[1])
                        and torch.equal(got[2], ref_[2])):
                    raise AssertionError(f"kernel 3 at n={n}: a later call "
                                         "differs")
        for n, (params, x, physics, norm) in ns_in.items():
            check_close(f"kernel 1 n={n} mses", first[("ns", n)][1],
                        mb.ns_residual_mse_plain(params, x, physics, norm),
                        1e-11)
        for n, (params, x, f) in p_in.items():
            check_close(f"kernel 3 n={n} mse", first[("poisson", n)][1],
                        mb.poisson_residual_mse_plain(params, x, f), 1e-11)
        print("  kernels 1 and 3 alternating n = 1000 / 50,000 and 200 / "
              "50,000, three rounds: every call bit-equal to the first at its "
              "size, which matches the plain version")

    with phase("14 device time per launch (torch.profiler)"):
        dev_t = {}
        gbar3 = torch.tensor(w3, dtype=f64, device=dev)
        gbar1 = torch.tensor([2.0], dtype=f64, device=dev)
        for n in (1000, 1_048_576):
            params, x, physics, norm = problem(2, n, 7, f64, dev)
            calls = 20 if n <= 10_000 else 3
            for key, fn in (
                    ("ns_residual_bwd", lambda: mb.ns_residual_bwd(
                        params, x, physics, norm, gbar3, with_loss=True)),
                    ("ns_residual_fwd", lambda: mb.ns_residual_fwd(
                        params, x, physics, norm))):
                dev_t[(key, n)] = device_profile(fn, calls)
            del params, x
        for n in (200, 1_048_576):
            params, x, f = poisson_problem(n, 7, f64, dev)
            calls = 20 if n <= 10_000 else 3
            for key, fn in (
                    ("poisson_residual_bwd", lambda: mb.poisson_residual_bwd(
                        params, x, f, gbar1, with_loss=True)),
                    ("poisson_residual_fwd", lambda: mb.poisson_residual_fwd(
                        params, x, f))):
                dev_t[(key, n)] = device_profile(fn, calls)
            del params, x, f
        for n in (1000, 1_048_576):
            params, x = bundle_problem((2,) + WIDTHS + (3,), n, 7, f64, dev)
            dev_t[("taylor_bundle", n)] = device_profile(
                lambda: mb.mlp_taylor_bundle(params, x),
                20 if n <= 10_000 else 3)
            del params, x
        torch.cuda.empty_cache()
        call_ms = {("ns_residual_bwd", 1000): times[("ns", "float64", 1000)]["bwd"],
                   ("ns_residual_fwd", 1000): times[("ns", "float64", 1000)]["fwd"],
                   ("poisson_residual_bwd", 200): times[("poisson", "float64", 200)]["bwd"],
                   ("poisson_residual_fwd", 200): times[("poisson", "float64", 200)]["fwd"],
                   ("ns_residual_bwd", 1_048_576): times[("ns", "float64", 1_048_576)]["bwd"],
                   ("ns_residual_fwd", 1_048_576): times[("ns", "float64", 1_048_576)]["fwd"],
                   ("poisson_residual_bwd", 1_048_576): times[("poisson", "float64", 1_048_576)]["bwd"],
                   ("poisson_residual_fwd", 1_048_576): times[("poisson", "float64", 1_048_576)]["fwd"],
                   ("taylor_bundle", 1000): times[("bundle", "float64", 1000)]["kernel"],
                   ("taylor_bundle", 1_048_576): times[("bundle", "float64", 1_048_576)]["kernel"]}
        for (key, n), (d_ms, per_call, names) in dev_t.items():
            print(f"  {key} n={n}: device {1e3 * d_ms:.2f} us per launch, "
                  f"{per_call:g} device kernels per call, call "
                  f"{call_ms[(key, n)]:.4f} ms (events); {names}")
            if per_call != 1:
                raise AssertionError(f"{key}: {per_call} device kernels per "
                                     f"call: {names}")
        record["device"] = {f"{k} {n}": {"device_ms": d, "per_call": c,
                                         "call_ms": call_ms[(k, n)]}
                            for (k, n), (d, c, _) in dev_t.items()}

    with phase("15 the slice: Poiseuille Adam 100 + dense BFGS 40, float64"):
        from tpinn_torch import config
        from tpinn_torch.cases import poiseuille_flow
        from tpinn_torch.optimize import minimize

        def bfgs_case(td, device, second_round="jax-bfgs",
                      iters=BFGS_ITERS, adam_epochs=100, resume_from=None):
            return poiseuille_flow.main(
                td, adam_epochs=adam_epochs, device=device,
                second_round=second_round, epochs=iters,
                resume_from=resume_from)

        with tempfile.TemporaryDirectory() as td:
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bfgs_drv = bfgs_case(td, "cuda")
            torch.cuda.synchronize()
            bfgs_wall = time.perf_counter() - t0
            bfgs_launches = dict(mb.LAUNCHES)
        pb = bfgs_drv.pb
        h = pb.history
        counts = pb.bfgs_counts
        n_it = counts["iterations"]
        print(f"  launches on the main path: {bfgs_launches}; wall "
              f"{bfgs_wall:.2f} s; {counts}")
        if pb.last_opt_state["kind"] != "bfgs_plain":
            raise AssertionError(f"variant {pb.last_opt_state['kind']}")
        if h.round_names != ["keras_Adam", "jax_BFGS"] or n_it != BFGS_ITERS:
            raise AssertionError(f"rounds {h.round_names}, {n_it} iterations")
        if not np.isfinite(np.concatenate(
                [h.loss_global] + [e["log"] for e in h.losses.values()]
                + [e["log"] for e in h.losses_test.values()])).all():
            raise AssertionError("non-finite logged loss")
        i_bfgs = [i for i, r in enumerate(h.rounds_idx) if r == 2]
        if not h.loss_global[i_bfgs[-1]] < h.loss_global[i_bfgs[0]]:
            raise AssertionError("BFGS did not reduce the loss")
        k1 = bfgs_launches["ns_residual_bwd"] - 100
        if (k1 != counts["evaluations"]
                or bfgs_launches["ns_residual_fwd"] != len(h.iters)
                or bfgs_launches["taylor_bundle"]
                or bfgs_launches["poisson_residual_bwd"]):
            raise AssertionError(f"main path launches {bfgs_launches} for "
                                 f"{counts}")
        trials = counts["trials"] / n_it
        bfgs_ms = 1e3 * h.wall_times[1] / n_it
        print(f"  per BFGS iteration: {(k1 - 1) / n_it:.3f} kernel-1 "
              f"launches (line-search trials + 2 = {trials + 2:.3f}), "
              f"{trials:.3f} trials, {bfgs_ms:.2f} ms (round wall / "
              f"iterations, logging and checkpoints included)")
        with tempfile.TemporaryDirectory() as td:
            ref = bfgs_case(td, "cpu")
        hr = ref.pb.history
        if hr.iters != h.iters:
            raise AssertionError(f"card and CPU log at other iterations "
                                 f"({h.iters} / {hr.iters})")
        head = [i for i, r in enumerate(hr.rounds_idx)
                if r == 1 or hr.iter_round[i] <= BFGS_HEAD_ITERS]
        d_head = rel_dev(hr, h, head)
        d_all = rel_dev(hr, h, list(range(len(h.iters))))
        d_final = abs(h.loss_global[-1] / hr.loss_global[-1] - 1.0)
        print(f"  loss_global {h.loss_global[i_bfgs[0]]:.6e} -> "
              f"{h.loss_global[-1]:.6e}; against the plain versions on the "
              f"CPU: Adam + BFGS iterations 0-{BFGS_HEAD_ITERS} "
              f"{d_head:.2e}, every log {d_all:.2e}, final global loss "
              f"{d_final:.2e} apart (CPU {hr.loss_global[-1]:.6e}, variant "
              f"{ref.pb.last_opt_state['kind']})")
        if d_head > HISTORY_BAR or d_final > FINAL_LOSS_BAR:
            raise AssertionError("card and CPU BFGS histories disagree")

        def logs(hist):
            return np.array([hist.loss_global]
                            + [e["log"] for e in hist.losses.values()]
                            + [e["log"] for e in hist.losses_test.values()])

        # a repeat from the same state (its callbacks off, so no checkpoint
        # is written), with every synchronising operation the host issues
        # recorded (torch's sync debug mode)
        import warnings

        with tempfile.TemporaryDirectory() as td, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            drv_b = bfgs_case(td, "cuda", second_round="none")
            drv_b.pb.callbacks.clear()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                minimize(drv_b.pb, "jax", "BFGS", num_epochs=BFGS_ITERS)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        same = np.array_equal(logs(drv_b.pb.history), logs(h))
        print(f"  repeat from the same state bit-identical: {same}; host "
              f"synchronisations in the round (sync debug mode) {syncs}, "
              f"{syncs / n_it:.2f} per iteration (line-search flags "
              f"{trials:.2f}, logged evaluations {len(i_bfgs) / n_it:.2f})")
        if not same:
            dev = np.max(np.abs(logs(drv_b.pb.history) - logs(h)))
            raise AssertionError(f"repeat differs by {dev:.3e}")
        with tempfile.TemporaryDirectory() as td:
            drv_c = bfgs_case(td, "cuda", second_round="none")
            drv_c.pb.callbacks.clear()
            minimize(drv_c.pb, "jax", "BFGS", num_epochs=BFGS_ITERS,
                     timed=True)
        iter_times = drv_c.pb.bfgs_times[1:]
        split = {k: 1e3 * float(np.median([t[k] for t in iter_times]))
                 for k in ("direction", "evaluations", "update")}
        split["round wall per iteration"] = (
            1e3 * drv_c.pb.history.wall_times[1] / n_it)
        timed_same = np.array_equal(logs(drv_c.pb.history), logs(h))
        print("  iteration split (device synchronised at each boundary, "
              "median of iterations 2-" + str(BFGS_ITERS) + "), ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; timed round bit-identical too: {timed_same}")
        if not timed_same:
            raise AssertionError("the timed round differs")
        with tempfile.TemporaryDirectory() as td:
            mb.reset_launch_counts()
            drv_d = bfgs_case(td, "cuda", second_round="scipy-parity",
                              iters=SCIPY_BFGS_ITERS)
            scipy_evals = mb.LAUNCHES["ns_residual_bwd"] - 100
        hd = drv_d.pb.history
        scipy_ms = 1e3 * hd.wall_times[1] / hd.iter_round[-1]
        print(f"  host scipy BFGS (scipy-parity), {hd.iter_round[-1]} "
              f"iterations: {scipy_ms:.2f} ms per iteration, "
              f"{scipy_evals / hd.iter_round[-1]:.2f} evaluations per "
              f"iteration; on-device BFGS {bfgs_ms:.2f} ms")
        if hd.round_names != ["keras_Adam", "scipy_BFGS"] or not scipy_evals:
            raise AssertionError(f"scipy round {hd.round_names}, "
                                 f"{scipy_evals} evaluations")
        config.set_dtype(torch.float32)
        try:
            with tempfile.TemporaryDirectory() as td:
                drv_e = bfgs_case(td, "cuda", iters=F32_BFGS_ITERS)
        finally:
            config.set_dtype(None)
        he = drv_e.pb.history
        e_bfgs = [i for i, r in enumerate(he.rounds_idx) if r == 2]
        f32_loss = np.array(he.loss_global)[e_bfgs]
        f64_loss = np.array([h.loss_global[i] for i in i_bfgs
                             if h.iter_round[i] <= F32_BFGS_ITERS])
        f32_err = float(np.max(np.abs(f32_loss - f64_loss) / f64_loss))
        print(f"  float32 round ({drv_e.pb.last_opt_state['kind']}), "
              f"{F32_BFGS_ITERS} iterations: loss_global {f32_loss[0]:.6e} "
              f"-> {f32_loss[-1]:.6e}; max rel deviation from float64 at "
              f"its log points {f32_err:.2e}")
        if (not np.isfinite(logs(he)).all() or not f32_loss[-1] < f32_loss[0]
                or drv_e.pb.last_opt_state["carry"][0].dtype != torch.float32):
            raise AssertionError("float32 BFGS round failed")
        record["bfgs_slice"] = {
            "launches": bfgs_launches, "counts": counts, "wall_s": bfgs_wall,
            "ms_per_iteration": bfgs_ms, "trials_per_iteration": trials,
            "kernel1_per_iteration": (k1 - 1) / n_it,
            "syncs_per_iteration": syncs / n_it, "split_ms": split,
            "scipy_ms_per_iteration": scipy_ms,
            "scipy_evals_per_iteration": scipy_evals / hd.iter_round[-1],
            "dev_head": d_head, "dev_all": d_all, "final_loss_rel": d_final,
            "f32_rel_err": f32_err, "loss_first": h.loss_global[i_bfgs[0]],
            "loss_last": h.loss_global[-1]}

    with phase("16 the paired variant: TPINN_USE_PALLAS=0, BFGS 20"):
        os.environ["TPINN_USE_PALLAS"] = "0"
        try:
            paired = {}
            for device in ("cuda", "cpu"):
                with tempfile.TemporaryDirectory() as td:
                    mb.reset_launch_counts()
                    paired[device] = (bfgs_case(td, device, adam_epochs=0,
                                                iters=PAIRED_ITERS),
                                      dict(mb.LAUNCHES))
        finally:
            os.environ.pop("TPINN_USE_PALLAS", None)
        (gpu, g_launch), (cpu, _) = paired["cuda"], paired["cpu"]
        kinds = [d.pb.last_opt_state["kind"] for d in (gpu, cpu)]
        d_paired = rel_dev(cpu.pb.history, gpu.pb.history,
                           list(range(len(gpu.pb.history.iters))))
        print(f"  variant {kinds}; launches {g_launch}; loss_global "
              f"{gpu.pb.history.loss_global[0]:.6e} -> "
              f"{gpu.pb.history.loss_global[-1]:.6e}; against the CPU: max "
              f"rel deviation of every log {d_paired:.2e}")
        if kinds != ["bfgs_paired"] * 2 or d_paired > HISTORY_BAR:
            raise AssertionError("paired round failed")
        record["paired"] = {"dev": d_paired, "launches": g_launch}

    with phase("17 Poisson jax-bfgs (kernels 3/4), Adam 100 + BFGS 20"):
        from tpinn_torch.cases import poisson

        runs = {}
        for device in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                runs[device] = (poisson.main(PAIRED_ITERS, out_dir=td,
                                             device=device,
                                             second_round="jax-bfgs")[0],
                                dict(mb.LAUNCHES))
        (p_gpu, p_bfgs_launches), (p_cpu, _) = runs["cuda"], runs["cpu"]
        hp = p_gpu.history
        d_poisson = rel_dev(p_cpu.history, hp, list(range(len(hp.iters))))
        pc = p_gpu.bfgs_counts
        print(f"  launches {p_bfgs_launches}; {pc}; variant "
              f"{p_gpu.last_opt_state['kind']}; loss_global "
              f"{hp.loss_global[0]:.6e} -> {hp.loss_global[-1]:.6e}; "
              f"against the CPU: max rel deviation of every log "
              f"{d_poisson:.2e}; BFGS {1e3 * hp.wall_times[1] / PAIRED_ITERS:.2f}"
              " ms per iteration")
        if (p_bfgs_launches["poisson_residual_bwd"] != 100 + pc["evaluations"]
                or p_bfgs_launches["poisson_residual_fwd"] != len(hp.iters)
                or p_gpu.last_opt_state["kind"] != "bfgs_plain"
                or hp.round_names != ["keras_Adam", "jax_BFGS"]
                or d_poisson > HISTORY_BAR):
            raise AssertionError("Poisson BFGS round failed")
        record["poisson_bfgs"] = {"launches": p_bfgs_launches, "counts": pc,
                                  "dev": d_poisson,
                                  "ms_per_iteration":
                                      1e3 * hp.wall_times[1] / PAIRED_ITERS}

    with phase("18 artifacts and exact resume on the card"):
        from tpinn_torch import checkpoint, utils

        with tempfile.TemporaryDirectory() as td:
            straight = bfgs_case(os.path.join(td, "a"), "cuda",
                                 iters=RESUME_ITERS)
            first = bfgs_case(os.path.join(td, "b"), "cuda",
                              iters=RESUME_ITERS // 2)
            resumed = bfgs_case(os.path.join(td, "b"), "cuda",
                                iters=RESUME_ITERS // 2,
                                resume_from=first.folder)
            written = sorted(os.listdir(first.folder))
            model, _ = checkpoint.load_experiment(first.folder,
                                                  device="cuda")
        hs, hr = straight.pb.history, resumed.pb.history
        s = logs(hs)[:, [i for i, r in enumerate(hs.rounds_idx) if r == 2]]
        r = logs(hr)
        r2 = r[:, [i for i, k in enumerate(hr.rounds_idx) if k == 2]]
        r3 = r[:, [i for i, k in enumerate(hr.rounds_idx) if k == 3]]
        d_resume = max(float(np.max(np.abs(r2 - s[:, :2]))),
                       float(np.max(np.abs(r3 - s[:, 1:]))))
        weights = "Weights.h5" if utils.has_module("h5py") else "Weights.npz"
        expect = sorted(["History_Loss.json", "Model.json",
                         "Test_Options.txt", weights, "checkpoint.pkl"]
                        + (["Graphic.jpg", "Loss_Trend_Full.png",
                            "Loss_Trend_Reduced.png"]
                           if utils.has_module("matplotlib") else []))
        x = torch.tensor(np.random.default_rng(3).uniform(0, 1, (1000, 2))
                         * np.array([1.0, 0.1]), device=dev)
        with torch.no_grad():
            same_out = torch.equal(model(x), resumed.model(x))
        print(f"  rounds {hr.round_names}; the carry adopted: "
              f"{resumed.pb.resume_opt_state is None}; straight "
              f"{RESUME_ITERS} against {RESUME_ITERS // 2} + resume "
              f"{RESUME_ITERS // 2}: largest difference of every log "
              f"{d_resume:.3e}; files {written}; load_experiment "
              f"reproduces the outputs bit for bit: {same_out}")
        if d_resume != 0.0 or resumed.pb.resume_opt_state is not None:
            raise AssertionError(f"resumed round differs from the straight "
                                 f"one by {d_resume:.3e}")
        if written != expect or not same_out:
            raise AssertionError(f"artifacts {written} (expected {expect}), "
                                 f"outputs equal {same_out}")
        record["resume"] = {"dev": d_resume, "files": written}

    with phase("19 the slice: Poiseuille Adam 100 + L-BFGS 100, float64"):
        def lbfgs_case(td, device, second_round="jax", iters=LBFGS_ITERS):
            return poiseuille_flow.main(td, adam_epochs=100, device=device,
                                        second_round=second_round,
                                        epochs=iters)

        with tempfile.TemporaryDirectory() as td:
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lbfgs_drv = lbfgs_case(td, "cuda")
            torch.cuda.synchronize()
            lbfgs_wall = time.perf_counter() - t0
            lbfgs_launches = dict(mb.LAUNCHES)
        pb = lbfgs_drv.pb
        h = pb.history
        counts = pb.lbfgs_counts
        n_it = counts["iterations"]
        print(f"  launches on the main path: {lbfgs_launches}; wall "
              f"{lbfgs_wall:.2f} s; {counts}")
        if h.round_names != ["keras_Adam", "jax_L-BFGS"] or n_it != LBFGS_ITERS:
            raise AssertionError(f"rounds {h.round_names}, {n_it} iterations")
        if not np.isfinite(logs(h)).all():
            raise AssertionError("non-finite logged loss")
        i_lb = [i for i, r in enumerate(h.rounds_idx) if r == 2]
        if not h.loss_global[i_lb[-1]] < h.loss_global[i_lb[0]]:
            raise AssertionError("L-BFGS did not reduce the loss")
        k1 = lbfgs_launches["ns_residual_bwd"] - 100
        if (k1 != counts["evaluations"] or k1 != counts["trials"] + 1
                or lbfgs_launches["ns_residual_fwd"] != len(h.iters)
                or lbfgs_launches["taylor_bundle"]
                or lbfgs_launches["poisson_residual_bwd"]):
            raise AssertionError(f"main path launches {lbfgs_launches} for "
                                 f"{counts}")
        lb_trials = counts["trials"] / n_it
        lbfgs_ms = 1e3 * h.wall_times[1] / n_it
        print(f"  per L-BFGS iteration: {k1 / n_it:.3f} kernel-1 launches "
              f"(trials {lb_trials:.3f}, + 1 on iteration 0), "
              f"{lbfgs_ms:.2f} ms (round wall / iterations, logging and "
              f"checkpoints included); dense BFGS (phase 15) {bfgs_ms:.2f} "
              f"ms")
        with tempfile.TemporaryDirectory() as td:
            ref = lbfgs_case(td, "cpu")
        hr = ref.pb.history
        if hr.iters != h.iters:
            raise AssertionError(f"card and CPU log at other iterations "
                                 f"({h.iters} / {hr.iters})")
        head = [i for i, r in enumerate(hr.rounds_idx)
                if r == 1 or hr.iter_round[i] <= LBFGS_HEAD_ITERS]
        lb_head = rel_dev(hr, h, head)
        lb_all = rel_dev(hr, h, list(range(len(h.iters))))
        lb_final = abs(h.loss_global[-1] / hr.loss_global[-1] - 1.0)
        print(f"  loss_global {h.loss_global[i_lb[0]]:.6e} -> "
              f"{h.loss_global[-1]:.6e}; against the plain versions on the "
              f"CPU: Adam + L-BFGS iterations 0-{LBFGS_HEAD_ITERS} "
              f"{lb_head:.2e}, every log {lb_all:.2e}, final global loss "
              f"{lb_final:.2e} apart (CPU {hr.loss_global[-1]:.6e}, "
              f"{ref.pb.lbfgs_counts})")
        if lb_head > HISTORY_BAR or lb_final > FINAL_LOSS_BAR:
            raise AssertionError("card and CPU L-BFGS histories disagree")
        with tempfile.TemporaryDirectory() as td, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            drv_b = lbfgs_case(td, "cuda", second_round="none")
            drv_b.pb.callbacks.clear()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                minimize(drv_b.pb, "jax", "L-BFGS", num_epochs=LBFGS_ITERS)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        lb_syncs = sum("synchroniz" in str(w.message) for w in caught)
        same = np.array_equal(logs(drv_b.pb.history), logs(h))
        print(f"  repeat from the same state bit-identical: {same}; host "
              f"synchronisations in the round (sync debug mode) {lb_syncs}, "
              f"{lb_syncs / n_it:.2f} per iteration (line-search flags "
              f"{lb_trials:.2f}, logged evaluations {len(i_lb) / n_it:.2f})")
        if not same:
            dev_b = np.max(np.abs(logs(drv_b.pb.history) - logs(h)))
            raise AssertionError(f"repeat differs by {dev_b:.3e}")
        with tempfile.TemporaryDirectory() as td:
            drv_c = lbfgs_case(td, "cuda", second_round="none")
            drv_c.pb.callbacks.clear()
            minimize(drv_c.pb, "jax", "L-BFGS", num_epochs=LBFGS_ITERS,
                     timed=True)
        iter_times = drv_c.pb.lbfgs_times[1:]
        lb_split = {k: 1e3 * float(np.median([t[k] for t in iter_times]))
                    for k in ("direction", "evaluations")}
        lb_split["round wall per iteration"] = (
            1e3 * drv_c.pb.history.wall_times[1] / n_it)
        timed_same = np.array_equal(logs(drv_c.pb.history), logs(h))
        print("  iteration split (device synchronised at each boundary, "
              "median of iterations 2-" + str(LBFGS_ITERS) + "), ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in lb_split.items())
              + f"; timed round bit-identical too: {timed_same}")
        if not timed_same:
            raise AssertionError("the timed round differs")
        record["lbfgs_slice"] = {
            "launches": lbfgs_launches, "counts": counts,
            "wall_s": lbfgs_wall, "ms_per_iteration": lbfgs_ms,
            "bfgs_ms_per_iteration": bfgs_ms,
            "trials_per_iteration": lb_trials,
            "kernel1_per_iteration": k1 / n_it,
            "syncs_per_iteration": lb_syncs / n_it, "split_ms": lb_split,
            "dev_head": lb_head, "dev_all": lb_all,
            "final_loss_rel": lb_final, "loss_first": h.loss_global[i_lb[0]],
            "loss_last": h.loss_global[-1]}

    with phase("20 the slice at full width: colliding flow, Adam 100 + "
               "BFGS 20; Poisson L-BFGS"):
        from tpinn_torch.cases import colliding_flow

        cf = {}
        for device in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                drv = colliding_flow.main(td, adam_epochs=100, device=device,
                                          epochs=COLLIDING_ITERS)
                torch.cuda.synchronize()
                cf[device] = (drv, dict(mb.LAUNCHES),
                              time.perf_counter() - t0,
                              sorted(os.listdir(drv.folder)))
        (cf_gpu, cf_launches, cf_wall, cf_files), (cf_cpu, _, cf_cpu_wall,
                                                  _) = cf["cuda"], cf["cpu"]
        hc, hcr = cf_gpu.pb.history, cf_cpu.pb.history
        cc = cf_gpu.pb.bfgs_counts
        names = [l.name for l in cf_gpu.losses]
        d_cf = rel_dev(hcr, hc, list(range(len(hc.iters))))
        d_cf_final = abs(hc.loss_global[-1] / hcr.loss_global[-1] - 1.0)
        cf_ms = 1e3 * hc.wall_times[1] / cc["iterations"]
        print(f"  losses {names}; launches {cf_launches}; {cc}; variant "
              f"{cf_gpu.pb.last_opt_state['kind']}; loss_global "
              f"{hc.loss_global[0]:.6e} -> {hc.loss_global[-1]:.6e}; "
              f"against the CPU: every log {d_cf:.2e}, final global loss "
              f"{d_cf_final:.2e} apart; BFGS {cf_ms:.2f} ms per iteration; "
              f"wall {cf_wall:.2f} s (CPU {cf_cpu_wall:.2f} s); final test "
              f"losses {cf_gpu.final_test_losses()}; files {cf_files}")
        if (hc.round_names != ["keras_Adam", "jax_BFGS"]
                or names[-1] != "Fit_p" or hc.iters != hcr.iters
                or cf_launches["ns_residual_bwd"] != 100 + cc["evaluations"]
                or cf_launches["ns_residual_fwd"] != len(hc.iters)
                or not np.isfinite(logs(hc)).all()
                or not hc.loss_global[-1] < hc.loss_global[0]
                or d_cf > HISTORY_BAR or d_cf_final > FINAL_LOSS_BAR):
            raise AssertionError("colliding flow round failed")
        if not {"History_Loss.json", "Model.json", "Test_Options.txt",
                "checkpoint.pkl"} <= set(cf_files):
            raise AssertionError(f"colliding flow artifacts {cf_files}")
        runs = {}
        for device in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                runs[device] = (poisson.main(POISSON_LBFGS_ITERS, out_dir=td,
                                             device=device,
                                             second_round="jax")[0],
                                dict(mb.LAUNCHES))
        (pl_gpu, p_lbfgs_launches), (pl_cpu, _) = runs["cuda"], runs["cpu"]
        hpl = pl_gpu.history
        d_pl = rel_dev(pl_cpu.history, hpl, list(range(len(hpl.iters))))
        plc = pl_gpu.lbfgs_counts
        pl_ms = 1e3 * hpl.wall_times[1] / POISSON_LBFGS_ITERS
        print(f"  Poisson L-BFGS: launches {p_lbfgs_launches}; {plc}; "
              f"loss_global {hpl.loss_global[0]:.6e} -> "
              f"{hpl.loss_global[-1]:.6e}; against the CPU: max rel "
              f"deviation of every log {d_pl:.2e}; {pl_ms:.2f} ms per "
              f"iteration")
        if (p_lbfgs_launches["poisson_residual_bwd"] != 100 + plc["evaluations"]
                or p_lbfgs_launches["poisson_residual_fwd"] != len(hpl.iters)
                or hpl.round_names != ["keras_Adam", "jax_L-BFGS"]
                or d_pl > HISTORY_BAR):
            raise AssertionError("Poisson L-BFGS round failed")
        record["colliding"] = {
            "launches": cf_launches, "counts": cc, "dev": d_cf,
            "final_loss_rel": d_cf_final, "ms_per_iteration": cf_ms,
            "wall_s": cf_wall, "cpu_wall_s": cf_cpu_wall,
            "test_losses": cf_gpu.final_test_losses(), "files": cf_files}
        record["poisson_lbfgs"] = {"launches": p_lbfgs_launches,
                                   "counts": plc, "dev": d_pl,
                                   "ms_per_iteration": pl_ms}

    with phase("21 the cosine-decay Adam second round, 100 epochs"):
        cos = {}
        for device in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                cos[device] = (poiseuille_flow.main(
                    td, adam_epochs=0, device=device, second_round="adam",
                    epochs=COSINE_EPOCHS), dict(mb.LAUNCHES))
        (cos_gpu, cos_launches), (cos_cpu, _) = cos["cuda"], cos["cpu"]
        hk = cos_gpu.pb.history
        d_cos = rel_dev(cos_cpu.pb.history, hk, list(range(len(hk.iters))))
        cos_ms = 1e3 * hk.wall_times[1] / COSINE_EPOCHS
        print(f"  rounds {hk.round_names}; launches {cos_launches}; "
              f"loss_global {hk.loss_global[0]:.6e} -> "
              f"{hk.loss_global[-1]:.6e}; against the CPU: max rel "
              f"deviation of every log {d_cos:.2e}; {cos_ms:.2f} ms per "
              f"epoch (round wall, logging included)")
        if (hk.round_names != ["keras_Adam", "keras_Adam"]
                or cos_launches["ns_residual_bwd"] != COSINE_EPOCHS
                or d_cos > HISTORY_BAR
                or not hk.loss_global[-1] < hk.loss_global[0]):
            raise AssertionError("cosine Adam round failed")
        record["cosine_adam"] = {"launches": cos_launches, "dev": d_cos,
                                 "ms_per_epoch": cos_ms}

    # launches on each path that runs the kernel, each read around its run;
    # "launches" is the count on the main path of the kernel's slice
    paths = {"4 Poiseuille Adam": launches,
             "8 Poisson Adam + L-BFGS-B": p_launches,
             "11 Poiseuille LM (opt-in)": lm_launches,
             "15 Poiseuille Adam + BFGS": bfgs_launches,
             "17 Poisson Adam + BFGS": p_bfgs_launches,
             "19 Poiseuille Adam + L-BFGS": lbfgs_launches,
             "20 colliding flow Adam + BFGS": cf_launches,
             "20 Poisson Adam + L-BFGS": p_lbfgs_launches,
             "21 Poiseuille cosine Adam": cos_launches}

    def kernel_row(name, key, route_src, replaces, main, row, n):
        d_ms, per_call, _ = dev_t[(name, n)]
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": replaces, "launches": main[name],
                "max_abs_err": errs[name], "ms": row[key],
                "plain_ms": row[f"plain_{key}"],
                "bound_ms": row[f"{key}_bound"],
                "bound_by": row[f"{key}_bound_by"], "library_ms": None,
                "device_ms": d_ms, "launches_per_call": per_call,
                "launches_by_path": {k: v[name] for k, v in paths.items()
                                     if v[name]}}

    ns_row = times[("ns", "float64", 1000)]
    p_row = times[("poisson", "float64", 200)]
    ns_src = "tpinn_torch/kernels/csrc/ns_residual.cu"
    p_src = "tpinn_torch/kernels/csrc/poisson_residual.cu"
    ref = "tpinn/pallas/mlp_bundle.py"
    kernels = [
        kernel_row("ns_residual_bwd", "bwd", ns_src, f"{ref}:556",
                   bfgs_launches, ns_row, 1000),
        kernel_row("ns_residual_fwd", "fwd", ns_src, f"{ref}:473",
                   bfgs_launches, ns_row, 1000),
        kernel_row("poisson_residual_bwd", "bwd", p_src, f"{ref}:1268",
                   p_launches, p_row, 200),
        kernel_row("poisson_residual_fwd", "fwd", p_src, f"{ref}:1209",
                   p_launches, p_row, 200),
    ]
    b_row = times[("bundle", "float64", 1000)]
    b_dev, b_per_call, _ = dev_t[("taylor_bundle", 1000)]
    kernels.append({
        "name": "taylor_bundle", "route": "cuda",
        "source": "tpinn_torch/kernels/csrc/taylor_bundle.cu",
        "replaces": f"{ref}:235", "launches": lm_launches["taylor_bundle"],
        "max_abs_err": errs["taylor_bundle"], "ms": b_row["kernel"],
        "plain_ms": b_row["plain"], "bound_ms": b_row["bound"],
        "bound_by": b_row["bound_by"], "library_ms": None,
        "device_ms": b_dev, "launches_per_call": b_per_call,
        "launches_by_path": {k: v["taylor_bundle"] for k, v in paths.items()
                             if v["taylor_bundle"]}})
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
