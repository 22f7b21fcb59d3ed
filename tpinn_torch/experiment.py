"""Experiment folders (``Test_Case_#NNN`` auto-numbering with a
``Last_Training`` scratch fallback) and the ``Test_Options.txt`` recap, as
the reference drivers write them."""

from __future__ import annotations

import os
from typing import Dict, Optional

DEFAULT_PREFIX = "Test_Case_#"
SCRATCH_FOLDER = "Last_Training"
RECAP_FILE = "Test_Options.txt"


def next_case_folder(base_dir: str = ".", prefix: str = DEFAULT_PREFIX) -> str:
    """Name of the next auto-numbered experiment folder (not yet created):
    ``prefix`` and three digits."""
    existing = [x for x in os.listdir(base_dir) if x.startswith(prefix)]
    if not existing:
        idx = 1
    else:
        idx = max(int(x[len(prefix):]) for x in existing) + 1
    return f"{prefix}{idx:03d}"


def prepare_folder(base_dir: str = ".", save_results: bool = True,
                   prefix: str = DEFAULT_PREFIX) -> str:
    """Create and return the run folder under ``base_dir`` (created if
    missing): a fresh ``prefix``NNN (``Test_Case_#NNN``) when
    ``save_results``, else the shared ``Last_Training`` scratch folder."""
    os.makedirs(base_dir, exist_ok=True)
    if save_results:
        folder = os.path.join(base_dir, next_case_folder(base_dir, prefix))
        os.makedirs(folder)
    else:
        folder = os.path.join(base_dir, SCRATCH_FOLDER)
        os.makedirs(folder, exist_ok=True)
    return folder


def write_recap(folder: str, problem_name: str, epochs: int,
                n_pts: Dict[str, int], noise_fit: float = 0.0,
                noise_bnd: float = 0.0, fit_velocity: Optional[bool] = None,
                fit_pressure: Optional[bool] = None,
                extra: Optional[Dict[str, object]] = None,
                echo: bool = True) -> str:
    """Write the reference recap ``Test_Options.txt`` into ``folder`` (its
    rows as the reference spells them) and return its path; ``echo``
    prints the rows too."""
    if fit_velocity is None:
        fit_velocity = n_pts.get("Vel", 0) > 0
    if fit_pressure is None:
        fit_pressure = n_pts.get("Pres", 0) > 0
    rows = [
        f"Problem Name    -> {problem_name}",
        f"Training Epochs -> {epochs} epochs",
        f"Pyhsical PDE Losses  -> {n_pts.get('PDE', 0)} points",
        f"Boundary Conditions  -> {n_pts.get('BC', 0)} points",
        f"Initial  Conditions  -> {n_pts.get('IC', 0)} points",
        f"Fitting Velocity  -> {n_pts.get('Vel', 0) if fit_velocity else 0} points",
        f"Fitting Pressure  -> {n_pts.get('Pres', 0) if fit_pressure else 0} points",
        f"Noise on Boundary -> {noise_bnd} times a gaussian N(0,1)",
        f"Noise on Domain   -> {noise_fit} times a gaussian N(0,1)",
    ]
    for k, v in (extra or {}).items():
        rows.append(f"{k} -> {v}")
    path = os.path.join(folder, RECAP_FILE)
    with open(path, "w") as f:
        for row in rows:
            f.write(row + "\n")
    if echo:
        print("\nSIMULATION OPTIONS RECAP...")
        for row in rows:
            print("\t", row)
    return path
