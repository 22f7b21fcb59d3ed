"""The accuracy recipes: each reference case trained to its reference row's
test losses by one command.

    python -m tpinn_torch.recipes --case poisson [--device cpu]
    python -m tpinn_torch.recipes --case all
    python -m tpinn_torch.recipes --list
    python -m tpinn_torch.recipes --case poiseuille --dry-run

A recipe is a list of stages run in order, each one process of the case's
module (``python -u -m tpinn_torch.cases.<case> ARGS``): a fresh Adam round
(the cosine-decay second round after the 100 plain epochs), then the
on-device dense BFGS, then chained Levenberg–Marquardt rounds.  Stage 1
trains into a fresh ``Test_Case_#NNN`` under the case's base dir
(``--base-dir``, by default ``.cache/tpinn_torch/runs/<case>/``), found by
listing that folder before and after; every later stage resumes it
(``{folder}``), so chained rounds continue one run.  The targets are
checked after every stage, and the case stops as soon as they are met.

Everything runs in float64, as the port always trains.  ``--device`` is
passed to every stage; without it each stage takes the CUDA card and fails
where there is none (never falling back to the CPU).  Each stage's output
goes to ``LOG_DIR/<case>/stageN_<tag>[_rK].log`` (``--log-dir``, by default
``docs/torch_runs/``), starting with its command, and the case's stage
walls, test losses and history rounds to ``LOG_DIR/<case>/summary.json``
(``read_summary``).  The last line printed is
``{"targets_met": {...}}``; the exit code is 1 when a stage's process failed
(a missed target is a result, not a failure).

The reference rows (BASELINE.md):
  poiseuille      ref #016: u/v/p_test 1.20e-9 / 8.11e-11 / 1.90e-11
  cavity_steady   ref #014: 5.01e-5 / 3.46e-4 / 6.90e-4
  colliding       ref #003: 2.05e-7 / 4.02e-7 / 2.25e-4
  cavity_unsteady ref #011 fit: 4.58e-4 / 3.52e-4 / 1.23e-4
  coronary        ref #123: 6.73e-5 / 6.47e-5 / 1.34e-5
  poisson         Report.pdf App. A.1: test MSE ~1e-7
  poisson_misto   Report.pdf App. A.2: test MSE ~1e-7, sup-norm 0.002
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_DIR = os.path.join(ROOT, "docs", "torch_runs")
BASE_DIR = os.path.join(ROOT, ".cache", "tpinn_torch", "runs")


def _stage(args, repeat=1, tag=None):
    return {"args": args, "repeat": repeat,
            "tag": tag or ("lm" if "lm" in args else "stage")}


def _driver_case(module):
    """A driver case's spec keys: its module, the flag of its base dir."""
    return {"module": f"tpinn_torch.cases.{module}", "dir_flag": "--base-dir"}


def _poisson_case(module, history):
    """A Poisson case's spec keys: it writes ``history`` under its
    ``--out-dir`` and no run folder."""
    return {"module": f"tpinn_torch.cases.{module}", "dir_flag": "--out-dir",
            "history": os.path.join("Images", history)}


# The manifest: each case is a list of stages run in order.  A stage with
# repeat > 1 is re-run (always resuming the SAME folder: the exact
# optimizer-state resume makes chained rounds one long round) until the
# case's targets are met or the repeats are spent.  {folder} is the fresh
# Test_Case folder of stage 1.
MANIFEST = {
    "poiseuille": {
        **_driver_case("poiseuille_flow"),
        "stages": [
            _stage(["--seed", "0", "--epochs", "50000",
                    "--second-round", "adam"], tag="adam"),
            _stage(["--resume", "{folder}", "--seed", "0", "--epochs",
                    "5000", "--second-round", "jax-bfgs"], tag="bfgs"),
            _stage(["--resume", "{folder}", "--seed", "0", "--epochs",
                    "300", "--second-round", "lm"], repeat=4),
        ],
        "targets": {"u_test": 1.20e-9, "v_test": 8.11e-11,
                    "p_test": 1.90e-11},
    },
    "cavity_steady": {
        **_driver_case("cavity_steady"),
        "stages": [
            _stage(["--seed", "2", "--epochs", "20000",
                    "--second-round", "adam"], tag="adam"),
            _stage(["--resume", "{folder}", "--seed", "2", "--epochs",
                    "5000", "--second-round", "jax-bfgs"], tag="bfgs"),
            _stage(["--resume", "{folder}", "--seed", "2", "--epochs",
                    "300", "--second-round", "lm"], repeat=4),
        ],
        "targets": {"u_test": 5.01e-5, "v_test": 3.46e-4, "p_test": 6.90e-4},
        "note": "the data is the oracle's full march (n_solver 128, 13,150 "
                "projection steps), made once into the base dir first",
    },
    "colliding": {
        **_driver_case("colliding_flow"),
        "stages": [
            _stage(["--seed", "0", "--epochs", "20000",
                    "--second-round", "adam"], tag="adam"),
            _stage(["--resume", "{folder}", "--seed", "0", "--epochs",
                    "5000", "--second-round", "jax-bfgs"], tag="bfgs"),
            _stage(["--resume", "{folder}", "--seed", "0", "--epochs",
                    "300", "--second-round", "lm"], repeat=3),
        ],
        "targets": {"u_test": 2.05e-7, "v_test": 4.02e-7, "p_test": 2.25e-4},
    },
    "cavity_unsteady": {
        **_driver_case("cavity_unsteady"),
        "stages": [
            _stage(["--seed", "0", "--epochs", "10000",
                    "--second-round", "adam"], tag="adam"),
            _stage(["--resume", "{folder}", "--seed", "0", "--epochs",
                    "5000", "--second-round", "jax-bfgs"], tag="bfgs"),
            # plain LM overfits the 5 % fit and boundary noise; the raised
            # PDE weights (mass 1e2, momentum 1e1) let the noise-free
            # physics dominate the least-squares system
            _stage(["--resume", "{folder}", "--seed", "0", "--epochs",
                    "250", "--second-round", "lm",
                    "--pde-weights", "1e2,1e1,1e1"], repeat=3),
        ],
        "targets": {"u_test": 4.58e-4, "v_test": 3.52e-4, "p_test": 1.23e-4},
    },
    "coronary": {
        **_driver_case("coronary_flow_steady"),
        "extra": ["--refine", "1", "--noise-bnd", "0.01"],
        "stages": [
            _stage(["--seed", "0", "--epochs", "40000",
                    "--second-round", "adam"], tag="adam"),
            _stage(["--resume", "{folder}", "--seed", "0", "--epochs",
                    "20000", "--second-round", "jax-bfgs"], tag="bfgs",
                   repeat=2),
            _stage(["--resume", "{folder}", "--seed", "0", "--epochs",
                    "450", "--second-round", "lm"], repeat=10),
        ],
        "targets": {"u_test": 6.73e-5, "v_test": 6.47e-5, "p_test": 1.34e-5},
        "note": "the longest case: Adam and BFGS alone take about an hour, "
                "then up to ten LM rounds of 450 iterations",
    },
    "poisson": {
        **_poisson_case("poisson", "Poisson_history_loss.json"),
        "stages": [
            _stage(["--epochs", "300", "--second-round", "lm"], tag="lm"),
        ],
        "targets": {"fit": 1e-7},
    },
    "poisson_misto": {
        **_poisson_case("poisson_misto", "Poisson_misto_history_loss.json"),
        "stages": [
            # one long LM round: the training losses converge within ~300
            # iterations, then the test MSE descends slowly (generalization
            # limited), so the 5e-8 target needs ~3000 iterations
            _stage(["--epochs", "3000", "--second-round", "lm"], tag="lm"),
        ],
        "targets": {"fit": 5e-8},
    },
}


# The quick recipes: Poisson's and Poiseuille's stages cut to a few
# iterations each (Poiseuille's plain Adam round to ``adam`` epochs), which
# check in seconds that the stages chain: the run folder, the resume and
# the early stop.
QUICK = {"poisson_lm": 3, "adam": 10, "cosine": 10, "bfgs": 3, "lm": 2,
         "lm_repeat": 2}


def quick_specs(target):
    """(poisson, poiseuille): the quick recipes, each target ``target``."""
    q, seed = QUICK, ["--seed", "0"]
    resume = ["--resume", "{folder}"] + seed
    poisson = dict(MANIFEST["poisson"], targets={"fit": target}, stages=[
        _stage(["--epochs", str(q["poisson_lm"]), "--second-round", "lm"],
               tag="lm")])
    poiseuille = dict(MANIFEST["poiseuille"], targets={
        k: target for k in ("u_test", "v_test", "p_test")}, stages=[
        _stage(seed + ["--adam-epochs", str(q["adam"]), "--epochs",
                       str(q["cosine"]), "--second-round", "adam"],
               tag="adam"),
        _stage(resume + ["--epochs", str(q["bfgs"]), "--second-round",
                         "jax-bfgs"], tag="bfgs"),
        _stage(resume + ["--epochs", str(q["lm"]), "--second-round", "lm"],
               repeat=q["lm_repeat"])])
    return poisson, poiseuille


def _rel(path):
    """``path`` relative to the checkout where it lies inside it (the stages
    run there), else absolute; None (a dry run's folder) as it is."""
    if path is None:
        return None
    path = os.path.abspath(path)
    rel = os.path.relpath(path, ROOT)
    return path if rel.startswith(os.pardir) else rel


def _existing_cases(base):
    pat = re.compile(r"Test_Case_#(\d+)$")
    return {d for d in os.listdir(base) if pat.search(d)}


def _final_test_losses(history_path):
    with open(history_path) as f:
        h = json.load(f)
    return {k: v["log"][-1] for k, v in h.get("losses_test", {}).items()}


def _targets_met(losses, targets):
    try:
        return all(losses[k] <= v for k, v in targets.items())
    except KeyError:
        return False


def history_without_walls(history_path):
    """A history file without its wall times, the one field that differs
    between two runs of the same stages."""
    with open(history_path) as f:
        h = json.load(f)
    h["log_rounds"].pop("wall_time_seconds")
    return h


def history_rounds(history_path):
    """The rounds of a History_Loss.json: name, first iteration, iterations
    run (its last logged point) and wall seconds, and whether the logged
    iterations run on (each round starting one past the last logged point
    of the one before, no point repeated)."""
    with open(history_path) as f:
        h = json.load(f)
    log = h["log"]
    rounds = h.get("log_rounds", {})
    names = rounds.get("rounds", [])
    starts = rounds.get("iteration_start", [])
    walls = rounds.get("wall_time_seconds", [0.0] * len(names))
    points = [[(i, k) for i, k, r in zip(log["iter"], log["iter_round"],
                                         log["round"]) if r == n]
              for n in range(1, len(names) + 1)]
    runs_on = all(b > a for a, b in zip(log["iter"], log["iter"][1:]))
    for r, start in enumerate(starts[1:], 1):
        runs_on = runs_on and bool(points[r - 1]) and (
            start == points[r - 1][-1][0] + 1)
    return {"rounds": [{"name": n, "start": s,
                        "iterations": p[-1][1] if p else 0, "wall_s": w}
                       for n, s, p, w in zip(names, starts, points, walls)],
            "runs_on": runs_on}


def read_summary(name, log_dir=LOG_DIR):
    """The report of ``run_case(name, ...)``: the stages' commands, walls,
    exit codes and test losses, the run folder, the stage that met the
    targets (``stopped_at``), the final test losses and history rounds, and
    ``failed``, the log of a stage whose process failed."""
    with open(os.path.join(log_dir, name, "summary.json")) as f:
        return json.load(f)


def run_case(name, spec, dry=False, device=None, log_dir=LOG_DIR,
             base_dir=BASE_DIR):
    """Run ``spec``'s stages for case ``name`` until its targets are met;
    True when they are, False when they are not or a stage's process
    failed.  The report goes to ``log_dir`` (``read_summary``)."""
    report = dict(case=name, device=device, targets=spec["targets"],
                  stages=[], failed=None, folder=None, stopped_at=None)
    print(f"=== {name}: {len(spec['stages'])} stages, targets "
          + ", ".join(f"{k}<={v:.3g}" for k, v in spec["targets"].items()))
    if spec.get("note"):
        print(f"    note: {spec['note']}")
    case_log_dir = os.path.join(log_dir, name)
    base = os.path.join(base_dir, name)
    if not dry:
        os.makedirs(case_log_dir, exist_ok=True)
        os.makedirs(base, exist_ok=True)
    # the history file is read only once a stage of this run has written
    # it: a Poisson case's (under the base dir) after its first stage exits
    # 0, a driver case's in the fresh run folder
    folder = history = None
    t_case = time.time()

    def finish(met):
        report.update(targets_met=met, wall_s=time.time() - t_case,
                      folder=folder and _rel(folder))
        if history and os.path.exists(history):
            report["final_test"] = _final_test_losses(history)
            report["history"] = history_rounds(history)
        with open(os.path.join(case_log_dir, "summary.json"), "w") as f:
            json.dump(report, f, indent=1)
        return met

    for si, stage in enumerate(spec["stages"], 1):
        for rep in range(1, stage["repeat"] + 1):
            args = [
                a.format(folder=_rel(folder)) if "{folder}" in a else a
                for a in stage["args"]
            ] + spec.get("extra", []) + [spec["dir_flag"], _rel(base)]
            if device is not None:
                args += ["--device", str(device)]
            env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", "")}
            cmd = [sys.executable, "-u", "-m", spec["module"]] + args
            tag = f"stage{si}_{stage['tag']}" + (
                f"_r{rep}" if stage["repeat"] > 1 else "")
            log = os.path.join(case_log_dir, tag + ".log")
            print(f"--- {name} {tag}: {' '.join(args)}")
            if dry:
                continue
            before = _existing_cases(base) if folder is None else None
            t0 = time.time()
            with open(log, "w") as lf:
                lf.write(f"# python {' '.join(cmd[1:])}\n")
                lf.flush()
                r = subprocess.run(cmd, stdout=lf, stderr=subprocess.STDOUT,
                                   env=env, cwd=ROOT)
            dt = time.time() - t0
            entry = {"tag": tag, "args": args, "returncode": r.returncode,
                     "wall_s": dt}
            report["stages"].append(entry)
            if r.returncode != 0:
                print(f"    FAILED (exit {r.returncode}, {dt:.0f}s) — "
                      f"see {_rel(log)}")
                report["failed"] = _rel(log)
                return finish(False)
            if before is not None:
                new = _existing_cases(base) - before
                if new:
                    folder = os.path.join(base, sorted(new)[-1])
                    history = os.path.join(folder, "History_Loss.json")
                    print(f"    -> fresh run folder {_rel(folder)}")
            if history is None and spec.get("history"):
                history = os.path.join(base, spec["history"])
            losses = (_final_test_losses(history)
                      if history and os.path.exists(history) else {})
            entry["test"] = losses
            shown = {k: f"{v:.3e}" for k, v in losses.items()
                     if k in spec["targets"]}
            print(f"    done in {dt:.1f}s; test {shown}")
            if _targets_met(losses, spec["targets"]):
                report["stopped_at"] = tag
                print(f"=== {name}: TARGETS MET in {time.time()-t_case:.0f}s "
                      f"(stage {si}, round {rep}) ===")
                return finish(True)
    if dry:
        return False
    met = _targets_met(_final_test_losses(history)
                       if history and os.path.exists(history) else {},
                       spec["targets"])
    status = "TARGETS MET" if met else "targets NOT met"
    print(f"=== {name}: {status} after all stages "
          f"({time.time()-t_case:.0f}s) ===")
    return finish(met)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="train the reference cases to their reference rows' "
                    "test losses, stage by stage")
    ap.add_argument("--case", default=None,
                    help="case name or 'all' (see --list)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the stage commands without running")
    ap.add_argument("--device", default=None,
                    help="passed to every stage (default: the CUDA card; "
                         "'cpu' runs the plain path)")
    ap.add_argument("--log-dir", default=LOG_DIR,
                    help="stage logs and summaries, one folder per case")
    ap.add_argument("--base-dir", default=BASE_DIR,
                    help="run folders and data, one folder per case")
    args = ap.parse_args(argv)
    if args.list or not args.case:
        for name, spec in MANIFEST.items():
            tgt = ", ".join(f"{k}<={v:.3g}"
                            for k, v in spec["targets"].items())
            print(f"{name:<16} python -m {spec['module']}")
            print(f"{'':<16} targets: {tgt}")
            for st in spec["stages"]:
                words = st["args"] + spec.get("extra", [])
                rep = f" x{st['repeat']}" if st["repeat"] > 1 else ""
                print(f"{'':<16}   {' '.join(words)}{rep}")
        return 0
    names = list(MANIFEST) if args.case == "all" else [args.case]
    for name in names:
        if name not in MANIFEST:
            raise SystemExit(f"unknown case {name!r}; use --list")
    results = {name: run_case(name, MANIFEST[name], dry=args.dry_run,
                              device=args.device, log_dir=args.log_dir,
                              base_dir=args.base_dir) for name in names}
    if args.dry_run:
        return 0
    failed = [log for log in (read_summary(name, args.log_dir)["failed"]
                              for name in names) if log]
    for log in failed:
        print(f"a stage failed: see {log}", file=sys.stderr)
    print(json.dumps({"targets_met": results}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
