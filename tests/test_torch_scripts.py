"""The port's counterparts of the JAX package's campaign and diagnostic
scripts, against the scripts (loaded by path) and against direct runs of
the cases (the diagnostics' are in tests/test_torch_diagnostics.py):

* ``tpinn_torch.campaign`` (scripts/run_all_cases.py): ``CASES`` maps the
  script's cases onto the port's case modules with the same epochs and
  reference strings; a two-case campaign at a tiny epochs scale equals the
  cases' ``main`` bit for bit; the table's lines equal the script's
  ``_write`` on the same rows apart from the backend line; a case that
  raises gets its ``ERROR`` row and the command exits 1;
* ``tpinn_torch.polish_scan`` (scripts/cavun_polish_scan.py): ``VARIANTS``
  and ``TARGETS`` equal the script's; the best-row selection and its lines
  equal the script's on the same History_Loss.json; a variant on a tiny
  Cavity_Unsteady run folder equals the case's own resume with the same
  weights, bit for bit, and leaves the folder untouched;
* ``tpinn_torch.lm_ab`` (scripts/lm_ladder_ab.py): each solver's two runs
  on a copy of a tiny Poiseuille folder equal two resumes of the case
  under the same solver, bit for bit;
* every new entry point raises without a card unless asked for the CPU
  (tests/test_torch_guards.py holds the imports).
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tests.test_torch_cavity_witness import series_dir
from tpinn_torch import campaign, diagnostics, entry, lm_ab, polish_scan
from tpinn_torch import witness
from tpinn_torch.cases import cavity_unsteady as cu
from tpinn_torch.cases import poiseuille_flow, poisson
from tpinn_torch.config import SimulationOptions
from tpinn_torch.recipes import history_without_walls

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One host BLAS thread (the LM rounds' eigh), as one torch thread."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    path = os.path.join(_REPO, "scripts", name)
    spec = importlib.util.spec_from_file_location(name[:-3] + "_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _options_file(path, **kw):
    SimulationOptions(**kw).to_file(path)
    return str(path)


# --------------------------------------------------------------- campaign


def test_campaign_cases_are_the_scripts():
    ref = _script("run_all_cases.py").CASES
    assert len(campaign.CASES) == len(ref)
    for (name, module, epochs, refs), (rname, path, repochs, rrefs) in zip(
            campaign.CASES, ref):
        assert (name, epochs, refs) == (rname, repochs, rrefs)
        assert module.rsplit(".", 1)[1] + ".py" == os.path.basename(path)
        assert module.startswith("tpinn_torch.cases.")


def test_tiny_campaign_equals_the_cases_main(tmp_path):
    out = tmp_path / "RESULTS.md"
    rc = campaign.main(["--only", "Poisson,Poiseuille_Flow", "--epochs-scale",
                        "0.0005", "--second-round", "jax", "--device", "cpu",
                        "--base-dir", str(tmp_path / "campaign"),
                        "--out", str(out)])
    assert rc == 0
    ref = tmp_path / "ref"
    poisson.main(5, out_dir=str(ref / "Poisson"), second_round="jax",
                 device="cpu")
    poiseuille_flow.main(str(ref / "Poiseuille_Flow"), second_round="jax",
                         epochs=5, device="cpu")
    for name, rel in (("Poisson", "Images/Poisson_history_loss.json"),
                      ("Poiseuille_Flow",
                       "Test_Case_#001/History_Loss.json")):
        got = history_without_walls(tmp_path / "campaign" / name / rel)
        want = history_without_walls(ref / name / rel)
        assert got == want, name
    lines = out.read_text().splitlines()
    assert lines[2] == ("Backend: `cpu` · second round: `jax` · epochs "
                        "scale: 0.0005")
    assert [l.split(" | ")[:2] for l in lines[6:]] == [
        ["| Poisson", "5"], ["| Poiseuille_Flow", "5"]]


def _rows():
    refs = {name: ref for name, _, _, ref in campaign.CASES}
    return [
        ("Poisson", 10000, refs["Poisson"],
         {"wall_seconds": 12.3, "final_test_losses": {"fit": 3.1e-9},
          "loss_global": 1e-9}),
        ("Poiseuille_Flow", 10000, refs["Poiseuille_Flow"],
         {"wall_seconds": 45.6, "final_test_losses": {
             "u_test": 1.5e-9, "v_test": 2.5e-10, "p_test": 7.125e-11},
          "loss_global": 1e-8}),
        ("Cavity_Steady", 10000, refs["Cavity_Steady"],
         {"error": "no card"}),
    ]


def test_campaign_table_equals_the_scripts(tmp_path):
    script = _script("run_all_cases.py")
    path = tmp_path / "ref.md"
    args = types.SimpleNamespace(second_round="jax-bfgs", epochs_scale=0.5)
    script._write(str(path), _rows(), args)
    want = path.read_text().splitlines()
    got = campaign.table(_rows(), "jax-bfgs", 0.5, "NVIDIA H100, 700.00 W")
    assert len(got) == len(want) == 9
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert want[2] == (f"Backend: `{jax.default_backend()}` · second round: "
                       "`jax-bfgs` · epochs scale: 0.5")
    assert got[2] == ("Backend: `NVIDIA H100, 700.00 W` · second round: "
                      "`jax-bfgs` · epochs scale: 0.5")


def test_campaign_error_row_exits_1(tmp_path, monkeypatch):
    real = campaign.call_main

    def failing(module, *a, **kw):
        if module.endswith("poisson_misto"):
            raise RuntimeError("diverged")
        return real(module, *a, **kw)

    monkeypatch.setattr(campaign, "call_main", failing)
    out = tmp_path / "RESULTS.md"
    rc = campaign.main(["--only", "Poisson,Poisson_misto", "--epochs-scale",
                        "0.0002", "--device", "cpu", "--base-dir",
                        str(tmp_path / "c"), "--out", str(out)])
    assert rc == 1
    lines = out.read_text().splitlines()
    assert lines[-1] == "| Poisson_misto | 7500 | ERROR: diverged | | |"
    assert lines[-2].startswith("| Poisson | 2 | ")


def test_entry_points_need_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    folder = str(tmp_path / "Test_Case_#001")
    calls = [
        lambda: campaign.main(["--out", str(tmp_path / "r.md"),
                               "--base-dir", str(tmp_path)]),
        lambda: polish_scan.main(["--folder", folder, "--data-dir",
                                  str(tmp_path)]),
        lambda: lm_ab.main(["--folder", folder]),
        lambda: diagnostics.main(["floor", "--folder", folder]),
        lambda: entry.main([]),
        lambda: entry.entry(),
        lambda: entry.dryrun_multichip(2),
        lambda: witness.main(["oracle", "--data-dir", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert os.listdir(tmp_path) == []


# ----------------------------------------------------------- polish scan


def test_polish_variants_and_targets_are_the_scripts():
    script = _script("cavun_polish_scan.py")
    assert polish_scan.VARIANTS == script.VARIANTS
    assert polish_scan.TARGETS == script.TARGETS


def _history(iters, rng):
    n = len(iters)
    tests = {k: {"log": list(rng.uniform(0.3, 3.0, n) * t)}
             for k, t in polish_scan.TARGETS.items()}
    return {"log": {"iter": list(iters)}, "losses_test": tests}


def test_best_row_equals_the_scripts(tmp_path, monkeypatch, capsys):
    """The script's ``run_variant`` with its driver replaced by one that
    writes a given polished history, against ``best_row`` on it.  The
    script's fixed work folder under /tmp is redirected into tmp_path
    (its ``os``, ``shutil`` and ``open``), so nothing is written outside
    it."""
    import tpinn.driver

    script = _script("cavun_polish_scan.py")
    rng = np.random.default_rng(7)
    before = list(range(0, 15103, 1000)) + [15102]
    after = before + list(range(15103, 15254, 10))
    h0, h1 = _history(before, rng), _history(after, rng)
    for k in h1["losses_test"]:
        h1["losses_test"][k]["log"][:len(before)] = \
            h0["losses_test"][k]["log"]
    case = tmp_path / "Test_Case_#003"
    case.mkdir()
    (case / "History_Loss.json").write_text(json.dumps(h0))
    scratch = tmp_path / "tmp"
    scratch.mkdir()

    def here(path):
        path = str(path)
        return (os.path.join(scratch, path[len("/tmp/"):])
                if path.startswith("/tmp/cavun_polish_") else path)

    monkeypatch.setattr(script, "os", types.SimpleNamespace(
        path=types.SimpleNamespace(
            join=os.path.join, exists=lambda p: os.path.exists(here(p))),
        makedirs=lambda p, **kw: os.makedirs(here(p), **kw)))
    monkeypatch.setattr(script, "shutil", types.SimpleNamespace(
        rmtree=lambda p, **kw: shutil.rmtree(here(p), **kw),
        copytree=lambda a, b, **kw: shutil.copytree(here(a), here(b), **kw)))
    monkeypatch.setattr(script, "open",
                        lambda p, *a, **kw: open(here(p), *a, **kw),
                        raising=False)

    class Driver:
        def __init__(self, *a, **kw):
            pass

        def train(self, resume_from):
            with open(os.path.join(here(resume_from), "History_Loss.json"),
                      "w") as f:
                json.dump(h1, f)

        def save_artifacts(self, loss_groups):
            pass

    @dataclasses.dataclass
    class Spec:
        weights: dict

    mod = types.SimpleNamespace(
        load_exact=lambda d: None, build_spec=lambda e: Spec({}),
        default_options=lambda: types.SimpleNamespace(epochs=0),
        LOSS_GROUPS={})
    monkeypatch.setattr(script, "CASE", str(case))
    monkeypatch.setattr(tpinn.driver, "StandardNSDriver", Driver)
    tag = "pde10"
    want = script.run_variant(mod, tag, polish_scan.VARIANTS["pde10"], 150)
    assert os.listdir(scratch) == [f"cavun_polish_{tag}"]
    want_out = capsys.readouterr().out
    got = polish_scan.best_row(h1, len(before), tag,
                               polish_scan.VARIANTS["pde10"], 150)
    assert got == want
    assert capsys.readouterr().out == want_out
    assert "*" in want_out


@pytest.fixture(scope="module")
def cavity_run(tmp_path_factory):
    """A tiny Cavity_Unsteady run folder on the committed series: Adam 5 +
    dense BFGS 2 at 64 PDE points."""
    base = tmp_path_factory.mktemp("cavity")
    data = series_dir(base / "data")
    opts = _options_file(base / "simulation_options.txt", epochs=2,
                         noise_fit=0.05, noise_bnd=0.05, n_pde=64, n_bc=16,
                         n_ic=16, n_vel=8, n_pres=0, n_test=32)
    exact = cu.load_exact(str(data))
    drv = cu.main(epochs=2, base_dir=str(base), second_round="jax-bfgs",
                  device="cpu", adam_epochs=5, exact_data=exact)
    return drv.folder, str(data), opts, exact


def test_polish_variant_equals_a_direct_resume(cavity_run, tmp_path):
    folder, data, opts, exact = cavity_run
    before = history_without_walls(os.path.join(folder, "History_Loss.json"))
    best = polish_scan.run_variant(folder, data, "pde10",
                                   polish_scan.VARIANTS["pde10"], 2,
                                   str(tmp_path / "scan"), device="cpu")
    got = history_without_walls(
        tmp_path / "scan" / "cavun_polish_pde10" / "Test_Case_#001"
        / "History_Loss.json")
    ref = tmp_path / "ref"
    ref.mkdir()
    shutil.copy(opts, ref / "simulation_options.txt")
    shutil.copytree(folder, ref / "Test_Case_#001")
    cu.main(epochs=2, base_dir=str(ref), second_round="lm",
            resume_from=str(ref / "Test_Case_#001"),
            pde_weights="1e2,1e1,1e1", device="cpu", exact_data=exact)
    want = history_without_walls(ref / "Test_Case_#001" / "History_Loss.json")
    assert got == want
    assert history_without_walls(
        os.path.join(folder, "History_Loss.json")) == before
    n0 = len(before["log"]["iter"])
    assert got["log_rounds"]["rounds"][-1] == "jax_LM"
    assert best[1] in got["log"]["iter"][n0:]
    assert best[0] == min(max(got["losses_test"][k]["log"][i] / t
                              for k, t in polish_scan.TARGETS.items())
                          for i in range(n0, len(got["log"]["iter"])))


# ------------------------------------------------------------------ lm_ab


@pytest.fixture(scope="module")
def poiseuille_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("poiseuille")
    opts = _options_file(base / "simulation_options.txt", epochs=0,
                         n_pde=100, n_bc=10, n_ic=0, n_vel=5, n_pres=0,
                         n_test=50)
    drv = poiseuille_flow.main(str(base), adam_epochs=5, second_round="none",
                               device="cpu", options_file=opts)
    return drv.folder, opts


@pytest.mark.parametrize("solver", ["host", "device"])
def test_lm_ab_equals_direct_resumes(poiseuille_run, tmp_path, monkeypatch,
                                     solver):
    folder, opts = poiseuille_run
    # one thread (PyTorch's and the host BLAS's) in the case's processes and
    # in this one: the ladder's Cholesky and the host eigh sum in another
    # order on more
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = lm_ab.run(solver, folder, iters=1, work_dir=str(tmp_path),
                    device="cpu")
    assert set(out) == {"folder", f"{solver}_run1", f"{solver}_run2"}
    got = history_without_walls(os.path.join(out["folder"],
                                             "History_Loss.json"))
    ref = tmp_path / "ref"
    ref.mkdir()
    copy = str(ref / "Test_Case_#001")
    shutil.copytree(folder, copy)
    monkeypatch.setenv("TPINN_LM_SOLVER", solver)
    with threadpool_limits(limits=1, user_api="blas"):
        for _ in range(2):
            drv = poiseuille_flow.main(str(ref), second_round="lm", epochs=1,
                                       device="cpu", options_file=opts,
                                       resume_from=copy)
    want = history_without_walls(os.path.join(copy, "History_Loss.json"))
    assert got == want
    assert got["log_rounds"]["rounds"][-2:] == ["jax_LM", "jax_LM"]
    assert out[f"{solver}_run2"]["test"] == drv.final_test_losses()
