"""Where a tile's time goes inside the fused residual kernels, on the card.

    python -m tpinn_torch.kernels.phase_probe [--out FILE]

Builds a copy of csrc/ under .cache/tpinn_torch/probe/ whose residual kernel
reads ``clock64()`` after every block barrier of block 0 and adds the cycles
since the previous barrier to a per-barrier counter (barriers counted from
the top of each tile), then runs kernels 1 and 3 (float64 and float32) at
the main shapes and at 1,048,576 points and prints, per call, the cycles per
tile spent before each barrier.  For a net of four Dense layers the
barriers of a tile are: the tile's inputs, layer 0, layers 1 and 2 (the
product and epilogue of each), the head product, the residual rows, the
backward phases of layers 3, 2, 1 and 0, and the tile's end; the slots past
them belong to the block's final partials.  The probe's stamps cost a few
cycles each; use its shares, and time the kernels with chip_smoke.py.
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


def _instrument(src: str) -> str:
    """The header with a clock stamp after every barrier of the kernel."""
    a = src.index("residual_kernel(const typename H::T*")
    b = src.index("bool make_net(")
    body = src[a:b]
    stamp = ("__syncthreads(); if (blockIdx.x == 0 && threadIdx.x == 0) { "
             "long long t_ = clock64(); g_phase[mark < 63 ? mark : 63] += "
             "t_ - t_mark; t_mark = t_; } ++mark;")
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
    return src + (
        '\nextern "C" int read_phases(long long* h) {\n'
        "  static long long z[64];\n"
        "  int r = cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n"
        "  cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n"
        "  return r;\n}\n")


def build_probe() -> dict:
    """Compile the instrumented sources; returns {source: CDLL}."""
    from tpinn_torch.kernels import build

    out = os.path.join(build.BUILD_DIR, "probe")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    path = os.path.join(out, "taylor_mlp.cuh")
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(_instrument(src))
    jobs = {}
    for stem in ("ns_residual", "poisson_residual"):
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               os.path.join(out, f"lib{stem}.so"),
               os.path.join(out, f"{stem}.cu")]
        jobs[stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for stem, proc in jobs.items():
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
            for kind, n in (("ns", 1000), ("ns", 1 << 20), ("poisson", 200),
                            ("poisson", 1 << 20)):
                if dtype == torch.float32 and n < 10_000:
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
    finally:
        for source in libs:
            build._libs.pop(source, None)
        mb._PLANS.clear()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
