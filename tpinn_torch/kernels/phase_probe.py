"""Where a tile's time goes inside the fused residual kernels and kernel 5,
on the card.

    python -m tpinn_torch.kernels.phase_probe [--out FILE]

Builds a copy of csrc/ under .cache/tpinn_torch/probe/ whose residual kernel
reads ``clock64()`` after every block barrier of block 0 and adds the cycles
since the previous barrier to a per-barrier counter (barriers counted from
the top of each tile), then runs kernels 1 and 3 (float64 and float32) at
the main shapes and at 1,048,576 points, and in float64 at the benchmark's
4,194,304, and prints, per call, the cycles per tile spent before each
barrier.  For a net of four Dense layers the
barriers of a tile are: the tile's inputs, layer 0, layers 1 and 2 (the
product and epilogue of each), the head product, the residual rows, the
backward phases of layers 3, 2, 1 and 0, and the tile's end; the slots past
them belong to the block's final partials.

Kernel 5 (csrc/taylor_bundle.cu) gets the same stamps in a copy under
.cache/tpinn_torch/probe5/, plus one barrier at the top of each tile, and
runs at 2-32-32-32-3 (dim 2) at 1,000 and 1,048,576 points, float64 and
float32: the block's one-time staging (weights, biases, first tile), then
per tile the previous tile's stores, layer 0, layers 1 and 2 and the head.
Then it times kernel 5 at 1,048,576 points (CUDA events, median of 10
single launches) at every tile size of the plan's candidates, each with
two blocks per SM where it fits and with one, the outputs bit-equal to the
planned call's: the two-blocks-per-SM question of PERF.md.

The probe's stamps cost a few cycles each (and kernel 5's extra barrier a
few more); use its shares, and time the kernels with chip_smoke.py.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

PHASES = ("tile inputs", "layer 0", "layer 1", "layer 2", "head product",
          "residual rows", "head backward", "layer 2 backward",
          "layer 1 backward", "layer 0 backward", "tile end")
BUNDLE_PHASES = ("staging", "stores", "layer 0", "layer 1", "layer 2", "head")
_STAMP = ("__syncthreads(); if (blockIdx.x == 0 && threadIdx.x == 0) { "
          "long long t_ = clock64(); g_phase[mark < 63 ? mark : 63] += "
          "t_ - t_mark; t_mark = t_; } ++mark;")
_READ = ('\nextern "C" int read_phases(long long* h) {\n'
         "  static long long z[64];\n"
         "  int r = cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n"
         "  cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n"
         "  return r;\n}\n")


def _instrument(src: str) -> str:
    """The header with a clock stamp after every barrier of the kernel."""
    a = src.index("residual_kernel(const typename H::T*")
    b = src.index("bool make_net(")
    body = src[a:b]
    stamp = _STAMP
    for anchor in ("{\n  using T = typename H::T;",
                   "    const int next = tile + gridDim.x;"):
        if anchor not in body:
            raise RuntimeError(f"phase_probe: anchor {anchor!r} not found")
    body = body.replace("{\n  using T = typename H::T;",
                        "{\n  long long t_mark = clock64(); int mark = 0;\n"
                        "  using T = typename H::T;", 1)
    body = body.replace("__syncthreads();", stamp)
    body = body.replace("    const int next = tile + gridDim.x;",
                        "    mark = 0;\n    const int next = tile + gridDim.x;", 1)
    src = src[:a] + body + src[b:]
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ long long g_phase[64];\n", 1)
    return src + _READ


def _instrument_bundle(src: str) -> str:
    """taylor_bundle.cu with a clock stamp after every barrier of its
    kernel: slot 0 the block's staging, then per tile slot 1 the previous
    tile's stores (a barrier added at the top of each tile and after the
    last), slots 2.. layer 0 to the head."""
    a = src.index("taylor_bundle_kernel(const T* __restrict__ x")
    b = src.index("template <typename T>\nvoid* kernel_of")
    body = src[a:b]
    anchors = {
        "  T* sm = reinterpret_cast<T*>(dynamic_smem());":
            "  long long t_mark = clock64(); int mark = 0;\n"
            "  T* sm = reinterpret_cast<T*>(dynamic_smem());",
        "    // prefetch the block's next tile":
            "    mark = 1; " + _STAMP + "\n    // prefetch the block's next tile",
        "  cp_async_wait<0>();\n}":
            "  mark = 1; " + _STAMP + "\n  cp_async_wait<0>();\n}",
    }
    for anchor in anchors:
        if body.count(anchor) != 1:
            raise RuntimeError(f"phase_probe: anchor {anchor!r} not found")
    body = body.replace("__syncthreads();", _STAMP)
    for anchor, repl in anchors.items():
        body = body.replace(anchor, repl, 1)
    src = src[:a] + body + src[b:]
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ long long g_phase[64];\n", 1)
    return src + _READ


def build_probe() -> dict:
    """Compile the instrumented sources; returns {source: CDLL}."""
    from tpinn_torch.kernels import build

    dirs = {}
    for sub, name, fn in (("probe", "taylor_mlp.cuh", _instrument),
                          ("probe5", "taylor_bundle.cu", _instrument_bundle)):
        out = dirs[sub] = os.path.join(build.BUILD_DIR, sub)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC, out)
        path = os.path.join(out, name)
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(fn(src))
    jobs = {}
    for sub, stem in (("probe", "ns_residual"), ("probe", "poisson_residual"),
                      ("probe5", "taylor_bundle")):
        out = dirs[sub]
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               os.path.join(out, f"lib{stem}.so"),
               os.path.join(out, f"{stem}.cu")]
        jobs[stem] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for stem, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"phase_probe: nvcc {stem} failed:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"lib{stem}.so"))
        for name, argtypes in build._SIGNATURES.items():
            if name.startswith(stem + "_"):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[stem + ".cu"] = lib
    return libs


def _params(widths, rng, dtype, device):
    import torch

    out = []
    for a, b in zip(widths[:-1], widths[1:]):
        lim = (6.0 / (a + b)) ** 0.5
        out.append({"kernel": torch.tensor(rng.uniform(-lim, lim, (a, b)),
                                           dtype=dtype, device=device),
                    "bias": torch.tensor(rng.uniform(-0.1, 0.1, b),
                                         dtype=dtype, device=device)})
    return out


BUNDLE_WIDTHS = (2, 32, 32, 32, 3)


def _bundle_case(n, dtype, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    params = _params(BUNDLE_WIDTHS, rng, dtype, dev)
    x = torch.tensor(rng.uniform(-1, 1, (n, 2)), dtype=dtype, device=dev)
    return params, x


def _tile_sizes(lib, dev, n=1 << 20, reps=10):
    """Kernel 5 (not instrumented) at n points launched at each candidate
    tile size with two blocks per SM where the block fits and with one:
    ms per launch (CUDA events, median of reps), each output bit-equal to
    the planned call's."""
    import torch

    from tpinn_torch.kernels import mlp_bundle as mb

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    L = len(BUNDLE_WIDTHS) - 1
    w_arr = (ctypes.c_int * (L + 1))(*BUNDLE_WIDTHS)
    rows = []
    for dtype in (torch.float64, torch.float32):
        params, x = _bundle_case(n, dtype, dev)
        f64 = dtype == torch.float64
        outs = [ctypes.c_int(0) for _ in range(4)]
        rc = lib.taylor_bundle_plan(int(f64), w_arr, L, 2, 2, n,
                                    *[ctypes.addressof(o) for o in outs])
        if rc:
            raise RuntimeError(f"taylor_bundle_plan failed with code {rc}")
        planned = outs[0].value, outs[1].value
        fn = lib.taylor_bundle_f64 if f64 else lib.taylor_bundle_f32
        w_ptrs = (ctypes.c_void_p * L)(*[p["kernel"].data_ptr()
                                         for p in params])
        b_ptrs = (ctypes.c_void_p * L)(*[p["bias"].data_ptr()
                                         for p in params])
        ref = torch.cat([t.reshape(-1)
                         for t in mb.mlp_taylor_bundle(params, x)])
        for P in mb.BUNDLE_TILE_POINTS:
            nbytes = mb.bundle_layout(BUNDLE_WIDTHS, 2, 2, P, False)["total"] \
                * x.element_size()
            if nbytes > mb.SMEM_LIMIT:
                continue
            for per_sm in (2, 1):
                if per_sm == 2 and nbytes > mb.TWO_BLOCK_SMEM:
                    continue
                G = min(-(-n // P), per_sm * sms)
                out = torch.empty(n * 3 * 5, dtype=dtype, device=dev)
                stream = torch.cuda.current_stream(dev).cuda_stream

                def launch():
                    rc = fn(x.data_ptr(), w_ptrs, b_ptrs, w_arr, L, 2, 2, n, P,
                            G, nbytes, 0, out.data_ptr(), stream)
                    if rc:
                        raise RuntimeError(f"launch failed: cudaError {rc}")

                launch()
                times = []
                for _ in range(reps):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    launch()
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b))
                times.sort()
                same = bool(torch.equal(out, ref))
                row = {"dtype": str(dtype)[6:], "P": P, "G": G,
                       "blocks_per_sm": per_sm, "bytes": nbytes,
                       "ms": times[reps // 2],
                       "planned": (P, G) == planned, "bit_equal": same}
                rows.append(row)
                print(f"kernel 5 {row['dtype']} n={n} P {P} G {G} ({per_sm} "
                      f"block(s) per SM, {nbytes} B): {row['ms']:.4f} ms"
                      f"{' (the plan)' if row['planned'] else ''}; output "
                      f"bit-equal to the planned call's: {same}", flush=True)
                if not same:
                    raise AssertionError("kernel 5's output depends on the "
                                         "tile size")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the counts as JSON")
    args = ap.parse_args()
    import numpy as np
    import torch

    from tpinn_torch.geometry import Normalization
    from tpinn_torch.kernels import build
    from tpinn_torch.kernels import mlp_bundle as mb
    from tpinn_torch.pipeline import NSPhysics

    if not torch.cuda.is_available():
        raise SystemExit("phase_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    plain_lib = build.library("taylor_bundle.cu")  # not instrumented
    libs = build_probe()
    build._libs.update(libs)
    mb._PLANS.clear()
    norm = Normalization(np.array([0.0, 2.0]), np.array([0.0, 1.0]),
                         np.array([0.0, 5.0]))
    physics = NSPhysics(conv=3.0, visc=0.5)
    record = {}
    print(f"card: {torch.cuda.get_device_name(0)}")
    try:
        for dtype in (torch.float64, torch.float32):
            for kind, n in (("ns", 1000), ("ns", 1 << 20), ("ns", 1 << 22),
                            ("poisson", 200), ("poisson", 1 << 20),
                            ("poisson", 1 << 22)):
                if dtype == torch.float32 and n != 1 << 20:
                    continue
                rng = np.random.default_rng(7)
                if kind == "ns":
                    params = _params((2, 32, 32, 32, 3), rng, dtype, dev)
                    x = torch.tensor(rng.uniform(0, 1, (n, 2)), dtype=dtype,
                                     device=dev)
                    g = torch.tensor((10.0, 1.0, 1.0), dtype=dtype, device=dev)
                    fn = lambda: mb.ns_residual_bwd(params, x, physics, norm, g)
                    lib = libs["ns_residual.cu"]
                else:
                    params = _params((2, 20, 20, 20, 1), rng, dtype, dev)
                    x = torch.tensor(rng.uniform(0, 6.28, (n, 2)), dtype=dtype,
                                     device=dev)
                    f = torch.sin(x[:, 0]) * torch.sin(x[:, 1])
                    g = torch.tensor([2.0], dtype=dtype, device=dev)
                    fn = lambda: mb.poisson_residual_bwd(params, x, f, g)
                    lib = libs["poisson_residual.cu"]
                buf = (ctypes.c_longlong * 64)()
                fn()
                torch.cuda.synchronize()
                lib.read_phases(buf)  # drop the first call's counts
                fn()
                torch.cuda.synchronize()
                lib.read_phases(buf)
                key = (f"{kind}_residual", 0, dtype)
                plan = [p for k, p in mb._PLANS.items()
                        if k[:3] == key and k[4] == n][0]
                tiles = len(range(0, -(-n // plan.P), plan.G))
                cycles = [round(v / tiles) for v in buf if v]
                name = (f"kernel {1 if kind == 'ns' else 3} "
                        f"{str(dtype)[6:]} n={n}")
                print(f"{name} (P {plan.P}, G {plan.G}, block 0 walked "
                      f"{tiles} tiles): {sum(cycles)} cycles per tile; "
                      + ", ".join(f"{PHASES[i] if i < len(PHASES) else i} "
                                  f"{c}" for i, c in enumerate(cycles)),
                      flush=True)
                record[name] = {"P": plan.P, "G": plan.G, "tiles": tiles,
                                "cycles": cycles}
        lib = libs["taylor_bundle.cu"]
        for dtype in (torch.float64, torch.float32):
            for n in (1000, 1 << 20):
                params, x = _bundle_case(n, dtype, dev)
                buf = (ctypes.c_longlong * 64)()
                mb.mlp_taylor_bundle(params, x)
                torch.cuda.synchronize()
                lib.read_phases(buf)  # drop the first call's counts
                mb.mlp_taylor_bundle(params, x)
                torch.cuda.synchronize()
                lib.read_phases(buf)
                plan = mb._PLANS[("taylor_bundle", 0, dtype, BUNDLE_WIDTHS, 2,
                                  n)]
                tiles = len(range(0, -(-n // plan.P), plan.G))
                cycles = [round(v / tiles) for v in buf[1:len(BUNDLE_PHASES)]]
                name = f"kernel 5 {str(dtype)[6:]} n={n}"
                print(f"{name} (P {plan.P}, G {plan.G}, block 0 walked "
                      f"{tiles} tiles): staging {buf[0]} cycles once; "
                      f"{sum(cycles)} cycles per tile; " + ", ".join(
                          f"{ph} {c}" for ph, c in
                          zip(BUNDLE_PHASES[1:], cycles)), flush=True)
                record[name] = {"P": plan.P, "G": plan.G, "tiles": tiles,
                                "staging": buf[0], "cycles": cycles}
        record["kernel 5 tile sizes"] = _tile_sizes(plain_lib, dev)
    finally:
        for source in libs:
            build._libs.pop(source, None)
        mb._PLANS.clear()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
