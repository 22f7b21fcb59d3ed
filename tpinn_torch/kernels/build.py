"""Build the CUDA kernels with nvcc into plain-C shared libraries and load
them with ctypes.

Each source under ``csrc/`` becomes its own library, built on first use into
``.cache/tpinn_torch/`` at the root of the checkout (listed in .gitignore),
keyed by a hash of the source, the shared headers and the flags, so an
unchanged tree reuses it.  The nvcc runs of all sources start together.  No
PyTorch header is compiled: a source with a plain ``extern "C"`` interface
builds in seconds, where one that includes PyTorch's headers takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("ns_residual.cu", "poisson_residual.cu", "taylor_bundle.cu",
           "roofline_probe.cu", "lbfgs_direction.cu")
HEADERS = ("taylor_mlp.cuh", "ptx.cuh")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), ".cache",
                         "tpinn_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
# entry point -> argtypes; every pointer (device, host array, stream) is a
# c_void_p so that ctypes never truncates it to a 32-bit int
_SIGNATURES = {
    "ns_residual_plan": [_I, _I, _P, _I, _I, _I, _P, _P, _P, _P],
    "ns_residual_bwd_f64": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _D, _D, _I,
                            _I, _I, _I, _P, _P, _P, _P],
    "ns_residual_bwd_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _D, _D, _I,
                            _I, _I, _I, _P, _P, _P, _P],
    "ns_residual_fwd_f64": [_P, _P, _P, _P, _I, _I, _I, _P, _D, _I, _I, _I,
                            _P, _P, _P, _P],
    "ns_residual_fwd_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _D, _I, _I, _I,
                            _P, _P, _P, _P],
    "poisson_residual_plan": [_I, _I, _P, _I, _I, _P, _P, _P, _P],
    "poisson_residual_bwd_f64": [_P, _P, _P, _P, _P, _I, _I, _D, _P, _D, _D,
                                 _I, _I, _I, _I, _P, _P, _P, _P],
    "poisson_residual_bwd_f32": [_P, _P, _P, _P, _P, _I, _I, _D, _P, _D, _D,
                                 _I, _I, _I, _I, _P, _P, _P, _P],
    "poisson_residual_fwd_f64": [_P, _P, _P, _P, _P, _I, _I, _D, _D, _I, _I,
                                 _I, _P, _P, _P, _P],
    "poisson_residual_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _D, _D, _I, _I,
                                 _I, _P, _P, _P, _P],
    "taylor_bundle_plan": [_I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "taylor_bundle_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                          _P],
    "taylor_bundle_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                          _P],
    "roofline_probe_f64": [_I, _I, _I, _I, _I, _P, _P, _P, _P],
    "roofline_probe_f32": [_I, _I, _I, _I, _I, _P, _P, _P, _P],
    "lbfgs_direction_f64": [_P] * 9 + [_L, _I, _I, _P],
    "lbfgs_direction_f32": [_P] * 9 + [_L, _I, _I, _P],
}


class BuildInfo:
    """What the last build did: the libraries' paths (one per source),
    whether nvcc ran, its wall seconds (all sources together) and the ptxas
    report (registers, shared memory, spills)."""

    def __init__(self, paths: Dict[str, str], compiled: bool, seconds: float,
                 log: str):
        self.paths = paths
        self.compiled = compiled
        self.seconds = seconds
        self.log = log


_libs: Dict[str, ctypes.CDLL] = {}
_info: Optional[BuildInfo] = None


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _source_hash(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _lib_path(build_dir: str, source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir, f"lib{stem}-{_source_hash(source)}.so")


def build(build_dir: str = BUILD_DIR) -> BuildInfo:
    """Compile every source whose hash has no library yet, all nvcc runs at
    once; return what happened.  Each library is written under a temporary
    name and renamed, so a concurrent or interrupted build never leaves a
    half-written one."""
    os.makedirs(build_dir, exist_ok=True)
    paths = {s: _lib_path(build_dir, s) for s in SOURCES}
    todo = [s for s in SOURCES if not os.path.exists(paths[s])]
    if not todo:
        return BuildInfo(paths, False, 0.0, "")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    try:
        for source in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
            jobs.append((source, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for source, tmp, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"[{source}]\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc {source} failed ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, paths[source])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return BuildInfo(paths, True, time.perf_counter() - t0, "".join(logs))


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, every library built on first use."""
    global _info
    if source not in _libs:
        if source not in SOURCES:
            raise ValueError(f"no kernel source {source!r}")
        if _info is None or not all(os.path.exists(p)
                                    for p in _info.paths.values()):
            _info = build()
        lib = ctypes.CDLL(_info.paths[source])
        prefix = os.path.splitext(source)[0] + "_"
        for name, argtypes in _SIGNATURES.items():
            if name.startswith(prefix):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[source] = lib
    return _libs[source]


def last_build() -> Optional[BuildInfo]:
    return _info


def parse_sass(text: str, name_regex: str, ops) -> Dict[tuple, Dict[str, int]]:
    """{groups of ``name_regex``: {op: count}} for each function of a
    ``cuobjdump -sass`` listing whose ``Function :`` line matches
    ``name_regex``; each op is counted once per instruction line naming it."""
    name_re = re.compile(name_regex)
    op_res = {op: re.compile(rf"\b{op}\b") for op in ops}
    counts: Dict[tuple, Dict[str, int]] = {}
    key = None
    for line in text.splitlines():
        m = name_re.search(line)
        if m:
            key = m.groups()
            counts[key] = {op: 0 for op in ops}
        elif "Function :" in line:
            key = None
        elif key is not None:
            for op, op_re in op_res.items():
                if op_re.search(line):
                    counts[key][op] += 1
    return counts


def sass_op_counts(lib_path: str, name_regex: str,
                   ops) -> Optional[Dict[tuple, Dict[str, int]]]:
    """``parse_sass`` of a built library's ``cuobjdump -sass``; None where
    the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    return parse_sass(out, name_regex, ops)
