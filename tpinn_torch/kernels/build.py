"""Build the CUDA kernels with nvcc into a plain-C shared library and load
it with ctypes.

The library is built on first use into ``.cache/tpinn_torch/`` at the root
of the checkout (listed in .gitignore), keyed by a hash of the sources and
the flags, so an unchanged tree reuses it.  No PyTorch header is compiled:
a source with a plain ``extern "C"`` interface builds in seconds, where one
that includes PyTorch's headers takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("ns_residual.cu",)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), ".cache",
                         "tpinn_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# entry point -> argtypes; every pointer (device, host array, stream) is a
# c_void_p so that ctypes never truncates it to a 32-bit int
_SIGNATURES = {
    "ns_residual_plan": [_I, _I, _P, _I, _I, _I, _P, _P, _P, _P],
    "ns_residual_bwd_f64": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _D, _D, _I,
                            _I, _I, _I, _P, _P, _P],
    "ns_residual_bwd_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _D, _D, _I,
                            _I, _I, _I, _P, _P, _P],
    "ns_residual_fwd_f64": [_P, _P, _P, _P, _I, _I, _I, _P, _D, _I, _I, _I,
                            _P, _P, _P],
    "ns_residual_fwd_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _D, _I, _I, _I,
                            _P, _P, _P],
}


class BuildInfo:
    """What the last build did: the library path, whether nvcc ran, its
    seconds and the ptxas report (registers, shared memory, spills)."""

    def __init__(self, path: str, compiled: bool, seconds: float, log: str):
        self.path = path
        self.compiled = compiled
        self.seconds = seconds
        self.log = log


_lib: Optional[ctypes.CDLL] = None
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


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(build_dir: str = BUILD_DIR) -> BuildInfo:
    """Compile the sources if their hash has no library yet; return what
    happened.  The library is written under a temporary name and renamed,
    so a concurrent or interrupted build never leaves a half-written one."""
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"libtpinn_kernels-{_source_hash()}.so")
    if os.path.exists(out):
        return BuildInfo(out, False, 0.0, "")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(CSRC, s) for s in SOURCES]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return BuildInfo(out, True, time.perf_counter() - t0,
                     proc.stdout + proc.stderr)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, _info
    if _lib is None:
        _info = build()
        lib = ctypes.CDLL(_info.path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def last_build() -> Optional[BuildInfo]:
    return _info
