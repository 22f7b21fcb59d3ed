"""Roofline probe: the attainable rate of each unit at the residual kernels'
own shapes, on the H100.

    python -m tpinn_torch.kernels.roofline_probe [--chunk 8] [--streams 5 6]
        [--reps 96] [--outer 10]

prints one JSON line per probe, dtype (float64, then float32) and stream
count, each over ``TILES`` tiles, with the JAX
package's keys (``probe``, ``rate_per_sec``, ``seconds``, ``chunk``,
``width``, ``streams``, ``reps``) and ``dtype``, ``tiles``, ``outer`` and
the time and rate of the same reps done by one PyTorch call each
(``library_seconds``, ``library_rate_per_sec``; null for the overlap probe,
which no single call computes).  It runs on the CUDA card only.

The five bodies are the JAX package's (scripts/roofline_probe.py), each a
bare CUDA kernel in csrc/roofline_probe.cu with a plain PyTorch version
here, on ``s`` of shape (tiles, S, 32, C) and W (32, 32):

* ``fwd_dot``: S chains a <- (Wᵀ·a)·1e-3, counted as 2·W²·C·S·R;
* ``gram_dot``: g_s += a_s·a_sᵀ, a <- 0.999·a, then broadcast(Σ_s g_s[:, 0])
  + 0·s, counted as 2·W²·C·S·R;
* ``vpu_fma``: a <- a·b + 0.5 with b the next stream, 2·W·C·S·R;
* ``tanh_elems``: a <- tanh(a), W·C·S·R elements;
* ``overlap_mix``: stream 0 the fwd chain, streams 1..S-1 the fma chains,
  2·W²·C·R + 2·W·C·(S−1)·R.

Float64 products run on the DMMA tensor cores, float32 ones as IEEE FFMA
(never TF32), the precisions of the port's kernels.  C is the residual
kernels' points per tile (``mlp_bundle.plan_points``: 8 at the slices' main
shapes, 16 or 32 at large batches), not the JAX probe's chunk of 2816 lanes:
that chunk is sized to a TPU core's vector memory, while on the H100 a
block holds one tile of C points, its S streams and W in shared memory, and
the card is filled with many such blocks.  A launch runs R reps on every
tile; ``outer`` launches chain (each reads the last one's output), and the
least time over ``repeats`` runs is kept, as the JAX probe does.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpinn_torch.kernels import mlp_bundle as mb

BODIES = ("fwd_dot", "gram_dot", "vpu_fma", "tanh_elems", "overlap_mix")
WIDTH = 32
STREAMS = (5, 6)
CHUNKS = (8, 16, 32)
TILES = 16384  # tiles per timed launch: about 120 blocks per SM
LAUNCHES: Dict[str, int] = {b: 0 for b in BODIES}
# the TPU bodies each probe replaces: scripts/roofline_probe.py
REPLACES = {"fwd_dot": "scripts/roofline_probe.py:101",
            "gram_dot": "scripts/roofline_probe.py:110",
            "vpu_fma": "scripts/roofline_probe.py:121",
            "tanh_elems": "scripts/roofline_probe.py:128",
            "overlap_mix": "scripts/roofline_probe.py:136"}
SOURCE = "tpinn_torch/kernels/csrc/roofline_probe.cu"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def default_chunk() -> int:
    """The residual kernels' points per tile on the unsteady slice's main
    path (3-32-32-32-3, float64, 10,000 PDE points)."""
    return mb.plan_points((3, 32, 32, 32, 3), 3, 3, 0, 8, 10_000)


def work(body: str, chunk: int, streams: int, reps: int,
         width: int = WIDTH) -> float:
    """The operations (or, for tanh, elements) one tile's reps count, as
    the JAX probe counts them."""
    W, C, S, R = width, chunk, streams, reps
    return {"fwd_dot": 2.0 * W * W * C * S * R,
            "gram_dot": 2.0 * W * W * C * S * R,
            "vpu_fma": 2.0 * W * C * S * R,
            "tanh_elems": 1.0 * W * C * S * R,
            "overlap_mix": 2.0 * W * W * C * R + 2.0 * W * C * (S - 1) * R,
            }[body]


# ---------------------------------------------------------------------------
# plain PyTorch versions, on s (..., S, W, C)
# ---------------------------------------------------------------------------


def fwd_plain(w, s, reps: int):
    a = s
    for _ in range(reps):
        a = torch.matmul(w.T, a) * 1e-3
    return a


def gram_plain(w, s, reps: int):
    S = s.shape[-3]
    a, g = s, None
    for _ in range(reps):
        prod = torch.matmul(a, a.transpose(-1, -2))
        g = prod if g is None else g + prod
        a = a * 0.999
    if g is None:
        g = torch.zeros(s.shape[:-1] + (s.shape[-2],), dtype=s.dtype,
                        device=s.device)
    total = g[..., 0, :, :]
    for i in range(1, S):
        total = total + g[..., i, :, :]
    return total[..., None, :, :1].expand(s.shape) + s * 0.0


def _next_streams(S: int):
    return [(i + 1) % S for i in range(S)]


def vpu_plain(w, s, reps: int):
    b = s[..., _next_streams(s.shape[-3]), :, :]
    a = s
    for _ in range(reps):
        a = a * b + 0.5
    return a


def tanh_plain(w, s, reps: int):
    a = s
    for _ in range(reps):
        a = torch.tanh(a)
    return a


def overlap_plain(w, s, reps: int):
    S = s.shape[-3]
    a0, rest = s[..., :1, :, :], s[..., 1:, :, :]
    b = s[..., [((i + 1) % S) or 1 for i in range(1, S)], :, :]
    for _ in range(reps):
        a0 = torch.matmul(w.T, a0) * 1e-3
        rest = rest * b + 0.5
    return torch.cat([a0, rest], dim=-3)


PLAIN: Dict[str, Callable] = {"fwd_dot": fwd_plain, "gram_dot": gram_plain,
                              "vpu_fma": vpu_plain, "tanh_elems": tanh_plain,
                              "overlap_mix": overlap_plain}


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check(body: str, w: torch.Tensor, s: torch.Tensor, reps: int) -> None:
    if body not in BODIES:
        raise ValueError(f"unknown probe {body!r}; choices: {BODIES}")
    if s.dim() != 4 or s.shape[2] != WIDTH or s.shape[1] not in STREAMS \
            or s.shape[3] not in CHUNKS or s.shape[0] < 1:
        raise ValueError(f"roofline probe: s has shape {tuple(s.shape)}; the "
                         f"kernels take (tiles, S, {WIDTH}, C) with S in "
                         f"{STREAMS} and C in {CHUNKS}")
    if tuple(w.shape) != (WIDTH, WIDTH):
        raise ValueError(f"roofline probe: w has shape {tuple(w.shape)}")
    if s.dtype not in (torch.float32, torch.float64) or w.dtype != s.dtype:
        raise ValueError("roofline probe: float32 or float64, w and s alike")
    if not (s.is_contiguous() and w.is_contiguous()) or w.device != s.device:
        raise ValueError("roofline probe: contiguous w and s on one device")
    if reps < 0:
        raise ValueError("roofline probe: reps must be >= 0")


def _launch(body: str, w, s, reps: int, out) -> None:
    from tpinn_torch.kernels import build

    lib = build.library("roofline_probe.cu")
    fn = (lib.roofline_probe_f64 if s.dtype == torch.float64
          else lib.roofline_probe_f32)
    rc = fn(BODIES.index(body), int(s.shape[1]), int(s.shape[3]), int(reps),
            int(s.shape[0]), w.data_ptr(), s.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"roofline probe {body} launch failed: "
                           f"cudaError {rc}")
    LAUNCHES[body] += 1


def probe(body: str, w: torch.Tensor, s: torch.Tensor, reps: int,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probe ``body`` on s (tiles, S, 32, C): its kernel on a CUDA
    tensor (into ``out`` when given), its plain version on a CPU tensor."""
    _check(body, w, s, reps)
    if s.device.type == "cpu":
        return PLAIN[body](w, s, reps)
    if s.device.type != "cuda":
        raise ValueError(f"roofline probe: no path for device {s.device}")
    if out is None:
        out = torch.empty_like(s)
    _launch(body, w, s, reps, out)
    return out


def library_reps(body: str, w: torch.Tensor, s: torch.Tensor,
                 reps: int) -> Optional[Callable[[], None]]:
    """The same reps' products or elementwise work, one PyTorch call per
    rep (the rescales left out): ``torch.matmul`` batched over tiles and
    streams for fwd_dot, ``baddbmm`` for gram_dot, ``addcmul`` for
    vpu_fma, ``tanh`` for tanh_elems; None for overlap_mix."""
    G, S, W, C = s.shape
    x = s.reshape(G * S, W, C).clone()
    y = torch.empty_like(x)
    if body == "fwd_dot":
        wt = w.T.contiguous()

        def run():
            a, b = x, y
            for _ in range(reps):
                torch.matmul(wt, a, out=b)
                a, b = b, a
    elif body == "gram_dot":
        g = torch.zeros(G * S, W, W, dtype=s.dtype, device=s.device)
        xt = x.transpose(1, 2)

        def run():
            for _ in range(reps):
                g.baddbmm_(x, xt)
    elif body == "vpu_fma":
        b_in = s[:, _next_streams(S)].reshape(G * S, W, C).contiguous()
        half = torch.tensor(0.5, dtype=s.dtype, device=s.device)

        def run():
            a, b = x, y
            for _ in range(reps):
                torch.addcmul(half, a, b_in, out=b)
                a, b = b, a
    elif body == "tanh_elems":
        def run():
            a, b = x, y
            for _ in range(reps):
                torch.tanh(a, out=b)
                a, b = b, a
    else:
        return None
    return run


def _events_seconds(fn: Callable[[], None], outer: int, repeats: int) -> float:
    """The least time, over ``repeats`` runs, of ``outer`` calls between two
    CUDA events (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(outer):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3)
    return best


def inputs(streams: int, chunk: int, tiles: int, dtype, device, seed: int = 0):
    """W (32, 32) and s (tiles, S, 32, C), N(0, 0.1²) from a seed, as the
    JAX probe draws them."""
    rng = np.random.default_rng(seed)
    w = torch.tensor(rng.normal(size=(WIDTH, WIDTH)) * 0.1, dtype=dtype,
                     device=device)
    s = torch.tensor(rng.normal(size=(tiles, streams, WIDTH, chunk)) * 0.1,
                     dtype=dtype, device=device)
    return w, s


def measure(body: str, dtype=torch.float64, streams: int = 5,
            chunk: Optional[int] = None, reps: int = 96, outer: int = 10,
            repeats: int = 4, device=None) -> dict:
    """Time ``outer`` chained launches of one probe over ``TILES`` tiles
    (and the library's same reps) on the card; the JSON record."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline probe measures the CUDA card; none "
                           "is available")
    device = torch.device(device or "cuda")
    chunk = chunk or default_chunk()
    tiles = TILES
    w, s = inputs(streams, chunk, tiles, dtype, device)
    bufs = [s, torch.empty_like(s)]

    def chained():
        probe(body, w, bufs[0], reps, out=bufs[1])
        bufs.reverse()

    seconds = _events_seconds(chained, outer, repeats)
    total = work(body, chunk, streams, reps) * tiles * outer
    lib = library_reps(body, w, s, reps)
    lib_s = _events_seconds(lib, outer, repeats) if lib is not None else None
    return {"probe": body, "rate_per_sec": total / seconds,
            "seconds": seconds, "chunk": chunk, "width": WIDTH,
            "streams": streams, "reps": reps,
            "dtype": str(dtype).replace("torch.", ""), "tiles": tiles,
            "outer": outer, "library_seconds": lib_s,
            "library_rate_per_sec": None if lib_s is None else total / lib_s}


# ---------------------------------------------------------------------------
# what nvcc made of the bodies
# ---------------------------------------------------------------------------

_KERNEL_RE = (r"Function : \S*?(fwd|gram|elem|overlap)_kernelI([df])"
              r"Li(\d)ELi(\d+)E(?:Lb([01])E)?")
_SASS_OPS = ("DMMA", "HMMA", "DFMA", "FFMA")
_KINDS = {"fwd": "fwd_dot", "gram": "gram_dot", "overlap": "overlap_mix"}


def _sass_key(kind, t, S, C, tanh) -> tuple:
    body = (_KINDS[kind] if kind != "elem"
            else ("tanh_elems" if tanh == "1" else "vpu_fma"))
    return (body, "float64" if t == "d" else "float32", int(S), int(C))


def sass_counts(lib_path: str) -> Optional[dict]:
    """{(body, dtype, S, C): {op: count}} of DMMA, HMMA, DFMA and FFMA in
    each instance's SASS (``cuobjdump -sass``); None without cuobjdump."""
    from tpinn_torch.kernels import build

    counts = build.sass_op_counts(lib_path, _KERNEL_RE, _SASS_OPS)
    if counts is None:
        return None
    return {_sass_key(*k): v for k, v in counts.items()}


def expected_sass(body: str, dtype: str, streams: int, chunk: int) -> dict:
    """What an instance's SASS must hold, per op: an exact count, or
    (unit, most) for a whole number of unrolled steps of ``unit`` up to
    ``most``.  The reps loop is not unrolled, so a float64 instance holds
    one rep's DMMA (the dot chains' 4 steps of 8 of K, each an m16n8k8 per
    pair of streams and two m8n8k4 for an odd S's last; m16n8k8 for the
    gram tiles, C/8 per stream) and DFMA (the fma chains).
    The float32 dot job's 32 k-steps (4 FFMA per stream each) and the
    gram's C points (a 2 x 2 tile per stream each) are loops that nvcc
    unrolls as it sees fit.  No DMMA in float32, no HMMA (TF32) anywhere;
    tanh's libdevice polynomial is not counted."""
    S, C = streams, chunk
    f64 = dtype == "float64"
    exp = {"HMMA": 0}
    if not f64:
        exp["DMMA"] = 0
    fmas = (S - 1) * WIDTH * C // (32 * (C // 8) * (4 if f64 else 2))
    if body == "fwd_dot":
        exp.update({"DMMA": WIDTH // 8 * (S // 2 + 2 * (S % 2))} if f64
                   else {"FFMA": (4 * S, 128 * S)})
    elif body == "gram_dot":
        exp.update({"DMMA": S * C // 8, "DFMA": 0} if f64
                   else {"FFMA": (4 * S, 4 * S * C)})
    elif body == "vpu_fma":
        exp.update({"DFMA": S * C // 8} if f64 else {"FFMA": S * C // 8})
    elif body == "overlap_mix":  # one stream's dot job, then the fma chains
        exp.update({"DMMA": 8, "DFMA": fmas} if f64
                   else {"FFMA_DOT": (4, 128)})
    return exp


def sass_problems(key: tuple, got: dict) -> list:
    """The ops of instance ``key`` = (body, dtype, S, C) whose SASS count
    breaks ``expected_sass``; [] when none does."""
    body, dtype, S, C = key
    bad = []
    for op, want in expected_sass(body, dtype, S, C).items():
        n = got["FFMA"] if op == "FFMA_DOT" else got[op]
        if op == "FFMA_DOT":  # the float32 overlap: the dot job's share
            n -= (S - 1) * WIDTH * C // (32 * (C // 8) * 2)
        ok = (n == want if isinstance(want, int)
              else n % want[0] == 0 and want[0] <= n <= want[1])
        if not ok:
            bad.append((op, n, want))
    return bad


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=None,
                    help="points per tile (default: the residual kernels' "
                         "tile on the unsteady main path)")
    ap.add_argument("--streams", type=int, nargs="+", default=[5, 6])
    ap.add_argument("--reps", type=int, default=96)
    ap.add_argument("--outer", type=int, default=10)
    args = ap.parse_args(argv)
    for dtype in (torch.float64, torch.float32):
        for S in args.streams:
            for body in BODIES:
                print(json.dumps(measure(body, dtype, S, args.chunk,
                                         args.reps, args.outer)), flush=True)


if __name__ == "__main__":
    main()
