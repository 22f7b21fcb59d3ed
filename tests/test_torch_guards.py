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
_FORBIDDEN_MODULES = ("jax", "optax", "h5py", "matplotlib", "tpinn", "pandas")


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


# the functions that may import an optional module, imported there when the
# function runs (never on the training path): file -> {function: module}
_LAZY_IMPORTS = {
    os.path.join("tpinn_torch", "utils.py"): {
        "_plot_history_dict": "matplotlib"},
    os.path.join("tpinn_torch", "viz.py"): {"_plt": "matplotlib"},
    os.path.join("tpinn_torch", "models.py"): {
        "save_weights": "h5py", "load_weights": "h5py"},
    os.path.join("tpinn_torch", "oracles", "io.py"): {
        "write_fields": "h5py", "read_fields": "h5py",
        "read_mesh_geometry": "h5py"},
}


def _function_body(text, name):
    """The source of the function ``name`` (to the next line indented no
    deeper than its ``def``)."""
    m = re.search(rf"^( *)def {name}\(", text, re.M)
    assert m, name
    indent = len(m.group(1))
    end = re.compile(rf"^ {{0,{indent}}}\S", re.M).search(text, m.end())
    return text[m.start():end.start() if end else len(text)]


@pytest.mark.parametrize("path", [os.path.relpath(p, _REPO) for p in _port_files()])
def test_port_file_has_no_forbidden_import(path):
    """No port file imports JAX, optax, h5py, matplotlib, pandas or tpinn;
    the exceptions are matplotlib inside ``utils._plot_history_dict`` and
    ``viz._plt`` and h5py inside ``Model.save_weights`` /
    ``Model.load_weights`` and the oracle's ``io.write_fields`` /
    ``io.read_fields`` / ``io.read_mesh_geometry``, each imported when a
    figure or an HDF5 file is written or read (never on the training
    path)."""
    with open(os.path.join(_REPO, path)) as f:
        text = f.read()
    for name, module in _LAZY_IMPORTS.get(path, {}).items():
        body = _function_body(text, name)
        assert re.search(rf"^\s+import\s+{module}\b", body, re.M), (name,
                                                                     module)
        others = [m for m in _FORBIDDEN_MODULES if m != module]
        assert not re.search(rf"^\s*(import|from)\s+({'|'.join(others)})\b",
                             body, re.M), name
        text = text.replace(body, "")
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(
        r"^\s*(import|from)\s+(optax|h5py|matplotlib|pandas)\b", text, re.M)
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


# the files that import scipy, each only inside the functions that use it:
# the scipy round, and the coronary oracle's sparse solves, node matching
# and Delaunay mesher (all on the host)
_SCIPY_FILES = tuple(os.path.join("tpinn_torch", *p) for p in (
    ("optimize.py",), ("oracles", "fem.py"), ("oracles", "coronary.py"),
    ("oracles", "coro_param.py")))


def test_scipy_only_inside_the_scipy_round():
    """scipy is imported by the scipy round and the coronary oracle alone,
    inside the functions that use it: importing the port loads no scipy."""
    for path in _port_files():
        with open(path) as f:
            lines = [l for l in f if re.match(r"\s*(import|from)\s+scipy\b", l)]
        rel = os.path.relpath(path, _REPO)
        if rel in _SCIPY_FILES:
            assert lines and all(l.startswith("    ") for l in lines), lines
        else:
            assert not lines, rel
    code = (
        "import pkgutil, importlib, sys, tpinn_torch\n"
        "for m in pkgutil.walk_packages(tpinn_torch.__path__, 'tpinn_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.exit(1 if 'scipy' in sys.modules else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_nisaba_namespace():
    """``import tpinn_torch as ns`` offers the surface the cases use."""
    import tpinn_torch as ns

    for name in ("GradientTape", "Loss", "LossMeanSquares",
                 "OptimizationProblem", "minimize", "models", "optimizers",
                 "utils", "geometry", "oracles", "experimental"):
        assert hasattr(ns, name), name
    ops = ns.experimental.physics.tens_style
    for name in ("gradient_scalar", "divergence_vector", "laplacian_scalar",
                 "laplacian_vector"):
        assert callable(getattr(ops, name)), name


def test_namespace_has_every_name_of_tpinn():
    """In a fresh interpreter ``import tpinn_torch as ns`` has every name of
    tpinn's ``__all__`` but ``sharding`` (not ported yet), e.g.
    ``ns.driver.run_second_round`` and ``ns.checkpoint.save_experiment``,
    and loads neither matplotlib nor h5py.  tpinn's list is read from its
    source, so that this test imports no JAX."""
    import ast

    with open(os.path.join(_REPO, "tpinn", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "__all__")
    names = [n for n in names if n != "sharding"]
    assert "driver" in names and "checkpoint" in names
    code = (
        "import sys, tpinn_torch as ns\n"
        f"missing = [n for n in {names!r} if not hasattr(ns, n)]\n"
        "missing += [n for n in ns.__all__ if not hasattr(ns, n)]\n"
        "ns.driver.run_second_round, ns.driver.SECOND_ROUND_CHOICES\n"
        "ns.checkpoint.save_experiment\n"
        "loaded = [m for m in ('matplotlib', 'h5py') if m in sys.modules]\n"
        "print(missing, loaded)\n"
        "sys.exit(1 if missing or loaded else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cases_refuse_to_run_silently_on_the_cpu(tmp_path, monkeypatch):
    """Without a card the Poisson cases and the three steady / old-style
    cavity cases raise unless given device='cpu', before any data is made
    or read."""
    from tpinn_torch.cases import (cavity_steady, cavity_steady_csv,
                                   cavity_unsteady_old, poisson,
                                   poisson_misto)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for case in (poisson, poisson_misto):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            case.main(1, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cavity_steady.main(1, base_dir=str(tmp_path))
    for case in (cavity_steady_csv, cavity_unsteady_old):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            case.main(1, out_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []
