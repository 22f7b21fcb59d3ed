"""tpinn_torch.config against tpinn.config: options files, dtype policy and
device resolution."""

import glob
import os

import pytest
import torch

from tpinn.config import SimulationOptions as JaxOptions
from tpinn_torch import config
from tpinn_torch.config import SimulationOptions

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OPTION_FILES = sorted(
    os.path.relpath(p, _REPO)
    for p in glob.glob(os.path.join(_REPO, "examples", "*",
                                    "simulation_options.txt")))


def test_example_option_files_exist():
    assert len(_OPTION_FILES) >= 3


@pytest.mark.parametrize("rel", _OPTION_FILES)
def test_options_file_parses_like_tpinn(rel):
    path = os.path.join(_REPO, rel)
    ours = SimulationOptions.from_file(path)
    ref = JaxOptions.from_file(path)
    assert vars(ours) == vars(ref)
    assert ours.n_pts == ref.n_pts
    for flag in ("use_collloss", "use_boundary", "use_initialc",
                 "fit_velocity", "fit_pressure"):
        assert getattr(ours, flag) == getattr(ref, flag)


def test_options_written_by_tpinn_parse_back(tmp_path):
    ref = JaxOptions(epochs=7, noise_fit=0.25, n_pde=33, n_vel=0)
    path = tmp_path / "simulation_options.txt"
    ref.to_file(path)
    assert vars(SimulationOptions.from_file(path)) == vars(ref)


def test_dtype_policy_defaults_to_float64():
    assert config.get_dtype() == torch.float64
    config.set_dtype(torch.float32)
    try:
        assert config.get_dtype() == torch.float32
    finally:
        config.set_dtype(None)
    assert config.get_dtype() == torch.float64


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.resolve_device(None)
    assert config.resolve_device("cpu") == torch.device("cpu")
