"""tpinn_torch.config against tpinn.config: options files, dtype policy and
device resolution; and the small API beside it (experiment folders with a
prefix, ``Loss.weighted_value``) against tpinn's."""

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


@pytest.mark.parametrize("writer", ["port", "tpinn"])
def test_options_written_by_tpinn_parse_back(tmp_path, writer):
    """Options written by the port's ``to_file`` (the same text as tpinn's)
    and by tpinn's read back through both packages."""
    kw = dict(epochs=7, noise_fit=0.25, n_pde=33, n_vel=0)
    ref = JaxOptions(**kw)
    path = tmp_path / "simulation_options.txt"
    if writer == "port":
        SimulationOptions(**kw).to_file(path)
        ref.to_file(tmp_path / "ref.txt")
        assert path.read_text() == (tmp_path / "ref.txt").read_text()
    else:
        ref.to_file(path)
    assert vars(SimulationOptions.from_file(path)) == vars(ref)
    assert vars(config.read_simulation_options(path)) == vars(ref)
    assert vars(JaxOptions.from_file(path)) == vars(ref)


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


def test_experiment_folders_and_weighted_value_match_tpinn(tmp_path):
    from tpinn import experiment as jexp
    from tpinn.losses import Loss as JaxLoss
    from tpinn_torch import experiment
    from tpinn_torch.losses import Loss

    assert experiment.DEFAULT_PREFIX == jexp.DEFAULT_PREFIX == "Test_Case_#"
    for prefix in (experiment.DEFAULT_PREFIX, "Run_"):
        for _ in range(2):
            want = jexp.next_case_folder(str(tmp_path), prefix=prefix)
            assert experiment.next_case_folder(str(tmp_path), prefix) == want
            folder = experiment.prepare_folder(str(tmp_path), prefix=prefix)
            assert os.path.basename(folder) == want
    assert sorted(os.listdir(tmp_path)) == [
        "Run_001", "Run_002", "Test_Case_#001", "Test_Case_#002"]
    loss = Loss("L", lambda: torch.tensor(3.0, dtype=torch.float64),
                weight=0.5, normalization=2.0)
    ref = JaxLoss("L", lambda: 3.0, weight=0.5, normalization=2.0)
    assert float(loss.weighted_value()) == float(ref.weighted_value()) == 0.75
