"""The port's accuracy recipes (``tpinn_torch.recipes``) against tpinn's
(``scripts/run_pure_tpu.py``): the manifest mapped stage by stage, the dry
run's stage tags, the readers of the test losses, and chained runs on the
CPU held bit for bit against the same stages called in this process.

The chained runs start their stages as processes with one thread each
(PyTorch's and BLAS's), as this process runs; they run in two threads
beside the in-process references, so the file takes about as long as its
longest chain."""

import contextlib
import importlib.util
import io
import json
import os
import re
import threading

import pytest
import torch

torch.set_num_threads(1)

from tpinn_torch import recipes  # noqa: E402
from tpinn_torch.cases import poiseuille_flow, poisson  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the card's default LM solver, the device damping ladder, forced on the
# CPU for every run of this file
_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
        "OPENBLAS_NUM_THREADS": "1", "TPINN_LM_SOLVER": "device"}


def _tpinn_recipes():
    """tpinn's runner, loaded by its path (it is a script, not a module of
    either package)."""
    path = os.path.join(_REPO, "scripts", "run_pure_tpu.py")
    spec = importlib.util.spec_from_file_location("run_pure_tpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# tpinn's recipe -> the port's: tpinn's script, the port's module, the
# flag that names the case's base dir, and the history file under it (a
# driver case's is the fresh run folder's History_Loss.json)
MAPPING = {
    "poiseuille": ("examples/Poiseuille_Flow/poiseuille_flow.py",
                   "tpinn_torch.cases.poiseuille_flow", "--base-dir", None),
    "cavity_steady": ("examples/Cavity_Steady/cavity_steady.py",
                      "tpinn_torch.cases.cavity_steady", "--base-dir", None),
    "colliding": ("examples/Colliding_Flow/colliding_flow.py",
                  "tpinn_torch.cases.colliding_flow", "--base-dir", None),
    "cavity_unsteady": ("examples/Cavity_Unsteady/cavity_unsteady.py",
                        "tpinn_torch.cases.cavity_unsteady", "--base-dir",
                        None),
    "coronary": ("examples/Coronary_Flow/coronary_flow_steady.py",
                 "tpinn_torch.cases.coronary_flow_steady", "--base-dir",
                 None),
    "poisson": ("examples/Poisson_Problem/poisson.py",
                "tpinn_torch.cases.poisson", "--out-dir",
                "Images/Poisson_history_loss.json"),
    "poisson_misto": ("examples/Poisson_Problem/poisson_misto.py",
                      "tpinn_torch.cases.poisson_misto", "--out-dir",
                      "Images/Poisson_misto_history_loss.json"),
}
# the port draws no figure without --plots, and trains in float64 throughout
DROPPED_ARGS = ("--no-plots",)
DROPPED_ENV = {"JAX_ENABLE_X64": "1"}


def test_manifest_maps_tpinns():
    ref = _tpinn_recipes().MANIFEST
    assert list(recipes.MANIFEST) == list(ref) == list(MAPPING)
    for name, (script, module, dir_flag, history) in MAPPING.items():
        mine, theirs = recipes.MANIFEST[name], ref[name]
        assert theirs["script"] == script
        assert mine["module"] == module and mine["dir_flag"] == dir_flag
        assert mine.get("history") == history
        if history is not None:
            assert theirs["history"].endswith("/" + history)
        else:
            assert "history" not in theirs and "artifact_dir" in theirs
        assert mine["targets"] == theirs["targets"]
        assert mine.get("extra", []) == theirs.get("extra", [])
        assert len(mine["stages"]) == len(theirs["stages"])
        for s_mine, s_theirs in zip(mine["stages"], theirs["stages"]):
            assert s_mine["args"] == [a for a in s_theirs["args"]
                                      if a not in DROPPED_ARGS]
            # tpinn's one stage environment, float64, is the port's own
            assert s_theirs["env"] in ({}, DROPPED_ENV)
            assert "env" not in s_mine
            assert (s_mine["repeat"], s_mine["tag"]) == (s_theirs["repeat"],
                                                         s_theirs["tag"])
    assert recipes.MANIFEST["coronary"]["extra"] == ["--refine", "1",
                                                     "--noise-bnd", "0.01"]
    lm = recipes.MANIFEST["cavity_unsteady"]["stages"][-1]["args"]
    assert lm[-2:] == ["--pde-weights", "1e2,1e1,1e1"]


def _stage_lines(text):
    return re.findall(r"^--- (\S+) (\S+):", text, re.M)


def test_dry_run_prints_tpinns_stage_tags(tmp_path, monkeypatch):
    ref = _tpinn_recipes()
    monkeypatch.setattr(ref, "LOG_DIR", str(tmp_path / "tpinn_logs"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for name, spec in ref.MANIFEST.items():
            ref.run_case(name, spec, dry=True)
    theirs = _stage_lines(out.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert recipes.main(["--dry-run", "--case", "all", "--log-dir",
                             str(tmp_path / "logs"), "--base-dir",
                             str(tmp_path / "runs")]) == 0
    mine = _stage_lines(out.getvalue())
    assert mine == theirs and len(mine) == 37
    # a dry run writes nothing
    assert not (tmp_path / "logs").exists()
    assert not (tmp_path / "runs").exists()


def test_cli_lists_and_dry_runs_without_a_card():
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    wants = {"--list": "poisson_misto",
             "--dry-run": "--- coronary stage3_lm_r10:"}
    procs = {flag: subprocess.Popen(
        [sys.executable, "-m", "tpinn_torch.recipes", flag, "--case", "all"]
        if flag == "--dry-run" else
        [sys.executable, "-m", "tpinn_torch.recipes", flag], cwd=_REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for flag in wants}
    for flag, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr
        assert wants[flag] in stdout and "targets_met" not in stdout


# the quick recipes' lengths
Q = recipes.QUICK
ADAM, COSINE, BFGS, LM, LM_REPEAT = (Q[k] for k in ("adam", "cosine", "bfgs",
                                                    "lm", "lm_repeat"))


def _bad_stage_1(spec):
    """``spec`` with an argument its stage 1 refuses."""
    first, *rest = spec["stages"]
    args = ["nonsense" if a == "adam" else a for a in first["args"]]
    return dict(spec, stages=[dict(first, args=args)] + rest)


def _in_process_poiseuille(base):
    """The cut-down recipe's stages through the case's ``main`` here."""
    drv = poiseuille_flow.main(base, adam_epochs=ADAM, second_round="adam",
                               epochs=COSINE, device="cpu", seed=0)
    for second_round, n in [("jax-bfgs", BFGS)] + [("lm", LM)] * LM_REPEAT:
        drv = poiseuille_flow.main(base, second_round=second_round, epochs=n,
                                   device="cpu", seed=0,
                                   resume_from=drv.folder)
    return os.path.join(drv.folder, "History_Loss.json")


def _run(name, spec, root, device="cpu"):
    log_dir = os.path.join(root, "logs")
    met = recipes.run_case(name, spec, device=device, log_dir=log_dir,
                           base_dir=os.path.join(root, "runs"))
    return met, recipes.read_summary(name, log_dir)


# where a Poisson case writes its history under a run's root; the failing
# CLI run starts with one an earlier run left there
OLD_HISTORY = os.path.join("runs", "poisson", "Images",
                           "Poisson_history_loss.json")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every chained run of this file, in two threads, beside the same
    stages called in this process."""
    root = str(tmp_path_factory.mktemp("recipes"))
    sub = lambda name: os.path.join(root, name)
    old = {k: os.environ.get(k) for k in _ENV}
    os.environ.update(_ENV)
    poisson_chain, chain = recipes.quick_specs(0.0)
    early, bad = recipes.quick_specs(1e9)[1], _bad_stage_1(chain)
    _write_history(os.path.join(sub("bad_cli"), OLD_HISTORY),
                   {"fit": [1.0, 1e-12]})
    jobs = [
        [("poiseuille", lambda: _run("poiseuille", chain, sub("chain")))],
        [("poisson", lambda: _run("poisson", poisson_chain, sub("chain"))),
         ("early", lambda: _run("poiseuille", early, sub("early"))),
         ("bad", lambda: _run("poiseuille", bad, sub("bad"))),
         ("bad_cli", lambda: _cli(["--case", "poisson", "--device",
                                   "no-such-device"], sub("bad_cli"))),
         ("no_card", lambda: _run("poisson", poisson_chain, sub("no_card"),
                                  device=None))],
    ]
    out, errors = {}, []

    def worker(todo):
        try:
            for key, fn in todo:
                out[key] = fn()
        except Exception as e:  # raised by the fixture below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(j,)) for j in jobs]
    try:
        for t in threads:
            t.start()
        poisson.main(Q["poisson_lm"], out_dir=sub("ref_poisson"),
                     second_round="lm", device="cpu")
        out["ref_poisson"] = os.path.join(sub("ref_poisson"), "Images",
                                          "Poisson_history_loss.json")
        out["ref_poiseuille"] = _in_process_poiseuille(sub("ref_poiseuille"))
    finally:
        for t in threads:
            t.join(timeout=600)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "a chain did not finish"
    out["root"] = root
    return out


def _cli(argv, root):
    """The CLI with its logs and runs under ``root``: (exit code, stderr)."""
    with contextlib.redirect_stderr(io.StringIO()) as err:
        rc = recipes.main(argv + ["--log-dir", os.path.join(root, "logs"),
                                  "--base-dir", os.path.join(root, "runs")])
    return rc, err.getvalue()


def _history(report):
    return os.path.join(report["folder"], "History_Loss.json")


def test_poiseuille_chain_equals_in_process_stages(runs):
    met, report = runs["poiseuille"]
    assert met is False and report["failed"] is None
    assert report["stopped_at"] is None
    tags = [s["tag"] for s in report["stages"]]
    assert tags == ["stage1_adam", "stage2_bfgs", "stage3_lm_r1",
                    "stage3_lm_r2"]
    assert all(s["returncode"] == 0 for s in report["stages"])
    folder = report["folder"]
    assert os.path.isabs(folder) and folder.endswith("Test_Case_#001")
    # every later stage resumed stage 1's folder, the only one made
    assert all(s["args"][s["args"].index("--resume") + 1] == folder
               for s in report["stages"][1:])
    assert os.listdir(os.path.dirname(folder)) == ["Test_Case_#001"]
    read = recipes.history_without_walls
    chained = read(os.path.join(folder, "History_Loss.json"))
    assert chained == read(runs["ref_poiseuille"])
    rounds = report["history"]
    assert rounds["runs_on"]
    assert [(r["name"], r["iterations"]) for r in rounds["rounds"]] == [
        ("keras_Adam", ADAM), ("keras_Adam", COSINE), ("jax_BFGS", BFGS),
        ("jax_LM", LM), ("jax_LM", LM)]
    logs = os.path.join(runs["root"], "chain", "logs", "poiseuille")
    with open(os.path.join(logs, "stage3_lm_r2.log")) as f:
        head = f.read().splitlines()[:2]
    assert head[0].startswith("# python -u -m tpinn_torch.cases."
                              "poiseuille_flow --resume ")
    assert not head[1].startswith("#")
    with open(os.path.join(logs, "summary.json")) as f:
        summary = json.load(f)
    assert summary["targets_met"] is False
    assert summary["final_test"] == report["final_test"]


def test_poisson_chain_equals_in_process_run(runs):
    met, report = runs["poisson"]
    assert met is False and report["failed"] is None
    assert [s["tag"] for s in report["stages"]] == ["stage1_lm"]
    assert report["folder"] is None
    history = os.path.join(runs["root"], "chain", "runs", "poisson",
                           "Images", "Poisson_history_loss.json")
    assert (recipes.history_without_walls(history)
            == recipes.history_without_walls(runs["ref_poisson"]))
    assert report["stages"][0]["test"] == recipes._final_test_losses(history)
    assert [r["name"] for r in report["history"]["rounds"]] == [
        "keras_Adam", "jax_LM"]


def test_met_target_stops_after_stage_1(runs):
    met, report = runs["early"]
    assert met is True and report["stopped_at"] == "stage1_adam"
    assert [s["tag"] for s in report["stages"]] == ["stage1_adam"]
    # stage 1 alone, as the full chain ran it
    read = recipes.history_without_walls
    full = read(_history(runs["poiseuille"][1]))
    early = read(os.path.join(report["folder"], "History_Loss.json"))
    n = len(early["log"]["iter"])
    assert early["log"]["loss_global"] == full["log"]["loss_global"][:n]
    assert early["log_rounds"]["rounds"] == ["keras_Adam", "keras_Adam"]


def test_failed_stage_returns_false_and_cli_exits_nonzero(runs):
    met, report = runs["bad"]
    log = os.path.join(runs["root"], "bad", "logs", "poiseuille",
                       "stage1_adam.log")
    assert met is False and report["failed"] == log
    assert [s["tag"] for s in report["stages"]] == ["stage1_adam"]
    with open(log) as f:
        assert "invalid choice: 'nonsense'" in f.read()
    with open(os.path.join(os.path.dirname(log), "summary.json")) as f:
        summary = json.load(f)
    assert summary["failed"] == log and summary["targets_met"] is False
    # the CLI: a stage that fails (here on a device that does not exist)
    # exits 1 and names its log
    rc, err = runs["bad_cli"]
    log = os.path.join(runs["root"], "bad_cli", "logs", "poisson",
                       "stage1_lm.log")
    assert rc == 1 and f"see {log}" in err
    with open(log) as f:
        assert "no-such-device" in f.read()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: the stage would run on it")
def test_stage_without_a_card_fails_and_never_falls_back(runs):
    met, report = runs["no_card"]
    assert met is False
    assert report["failed"] and report["stages"][0]["returncode"] != 0
    assert "--device" not in report["stages"][0]["args"]
    with open(report["failed"]) as f:
        assert "none is available" in f.read()


def test_failed_poisson_stage_reads_no_older_history(runs):
    """The CLI's Poisson stage failed on top of a history an earlier run
    left under the base dir: the report holds none of that run's losses."""
    old = os.path.join(runs["root"], "bad_cli", OLD_HISTORY)
    assert recipes._final_test_losses(old) == {"fit": 1e-12}
    summary = recipes.read_summary("poisson", os.path.join(
        runs["root"], "bad_cli", "logs"))
    assert summary["failed"] and summary["targets_met"] is False
    assert "final_test" not in summary and "history" not in summary
    assert "test" not in summary["stages"][0]


def _write_history(path, tests):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    h = {"log": {"iter": [0, 10, 11], "round": [1, 1, 2],
                 "iter_round": [0, 10, 0], "loss_global": [1.0, 0.5, 0.4]},
         "losses": {},
         "losses_test": {k: {"weight": 1.0, "log": v}
                         for k, v in tests.items()},
         "log_rounds": {"rounds": ["keras_Adam", "jax_LM"],
                        "iteration_start": [0, 11],
                        "wall_time_seconds": [1.0, 2.0]}}
    with open(path, "w") as f:
        json.dump(h, f)
    return path


def test_readers_equal_tpinns(runs, tmp_path):
    ref = _tpinn_recipes()
    targets = {"u_test": 1e-3, "v_test": 1e-3, "p_test": 1e-3}
    at = {"u_test": [1.0, 1e-3], "v_test": [1.0, 5e-4],
          "p_test": [1.0, 1e-4]}
    files = {
        "chain": _history(runs["poiseuille"][1]),
        "poisson": os.path.join(runs["root"], "chain", "runs", "poisson",
                                "Images", "Poisson_history_loss.json"),
        "at the bound": _write_history(tmp_path / "a.json", at),
        "above it": _write_history(
            tmp_path / "b.json", {**at, "u_test": [1.0, 1.0000001e-3]}),
        "a key missing": _write_history(
            tmp_path / "c.json", {k: v for k, v in at.items()
                                  if k != "p_test"}),
        "no test loss": _write_history(tmp_path / "d.json", {}),
    }
    met = {}
    for name, path in files.items():
        losses = recipes._final_test_losses(path)
        assert losses == ref._final_test_losses(path)
        for tgt in (targets, {"fit": 1e-7}, {"fit": 1e9}, {}):
            met[name, tuple(tgt)] = recipes._targets_met(losses, tgt)
            assert met[name, tuple(tgt)] == ref._targets_met(losses, tgt)
    key = tuple(targets)
    assert met["at the bound", key] and not met["above it", key]
    assert not met["a key missing", key] and not met["no test loss", key]
    # the rounds of a history, and a gap between them
    assert recipes.history_rounds(files["at the bound"])["runs_on"]
    gap = _write_history(tmp_path / "e.json", at)
    with open(gap) as f:
        h = json.load(f)
    h["log_rounds"]["iteration_start"] = [0, 12]
    with open(gap, "w") as f:
        json.dump(h, f)
    assert not recipes.history_rounds(gap)["runs_on"]
