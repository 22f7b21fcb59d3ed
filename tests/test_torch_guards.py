"""Guards of the port: it stands alone (no JAX, optax, h5py, matplotlib or
tpinn import), builds no PyTorch extension, refuses to run silently on the
CPU, and keeps its build output out of git."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN_MODULES = ("jax", "optax", "h5py", "matplotlib", "tpinn")


def _port_files():
    out = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(_REPO, "tpinn_torch")):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(out)


def test_import_leaves_reference_stack_unloaded():
    code = (
        "import pkgutil, importlib, sys, tpinn_torch\n"
        "for m in pkgutil.walk_packages(tpinn_torch.__path__, 'tpinn_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN_MODULES!r}]\n"
        "print(len(list(pkgutil.walk_packages(tpinn_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", [os.path.relpath(p, _REPO) for p in _port_files()])
def test_port_file_has_no_forbidden_import(path):
    with open(os.path.join(_REPO, path)) as f:
        text = f.read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+(optax|h5py|matplotlib)\b",
                         text, re.M)
    assert not re.search(r"^\s*from\s+tpinn(\.|\s)", text, re.M)
    assert not re.search(r"^\s*import\s+tpinn(\.|\s|$)", text, re.M)
    assert "cpp_extension" not in text
    assert "torch/extension.h" not in text


def test_build_directory_is_gitignored():
    from tpinn_torch.kernels import build

    rel = os.path.relpath(build.BUILD_DIR, _REPO)
    assert rel.split(os.sep)[0] == ".cache"
    with open(os.path.join(_REPO, ".gitignore")) as f:
        lines = [l.strip() for l in f]
    assert ".cache/" in lines


def test_kernel_module_imports_build_nothing():
    """Importing the kernels compiles and loads nothing (the tests import
    every module; nvcc exists only where the card is)."""
    from tpinn_torch.kernels import build

    assert build.last_build() is None
    assert build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the smoke exits non-zero and prints no result; alone in
    a directory (no tpinn_torch beside it) it does the same."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for cwd, script in ((_REPO, os.path.join(_REPO, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != _REPO:
            with open(os.path.join(_REPO, "chip_smoke.py")) as f:
                (tmp_path / "chip_smoke.py").write_text(f.read())
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
