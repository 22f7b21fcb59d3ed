"""Experiment folders: ``Test_Case_#NNN`` auto-numbering with a
``Last_Training`` scratch fallback, as the reference drivers do."""

from __future__ import annotations

import os

CASE_PREFIX = "Test_Case_#"
SCRATCH_FOLDER = "Last_Training"


def next_case_folder(base_dir: str = ".") -> str:
    """Name of the next auto-numbered experiment folder (not yet created)."""
    existing = [x for x in os.listdir(base_dir) if x.startswith(CASE_PREFIX)]
    if not existing:
        idx = 1
    else:
        idx = max(int(x[len(CASE_PREFIX):]) for x in existing) + 1
    return f"{CASE_PREFIX}{idx:03d}"


def prepare_folder(base_dir: str = ".", save_results: bool = True) -> str:
    """Create and return the run folder under ``base_dir`` (created if
    missing): a fresh ``Test_Case_#NNN`` when ``save_results``, else the
    shared ``Last_Training`` scratch folder."""
    os.makedirs(base_dir, exist_ok=True)
    if save_results:
        folder = os.path.join(base_dir, next_case_folder(base_dir))
        os.makedirs(folder)
    else:
        folder = os.path.join(base_dir, SCRATCH_FOLDER)
        os.makedirs(folder, exist_ok=True)
    return folder
