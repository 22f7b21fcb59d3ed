"""Training history with the reference's History_Loss.json schema.

    { "log":    { "iter": [...], "round": [...], "iter_round": [...],
                  "loss_global": [...] },
      "losses":      { name: {weight, non_negative, display_sqrt, log}, ... },
      "losses_test": { same },
      "log_rounds":  { "rounds": [names], "iteration_start": [ints],
                       "wall_time_seconds": [floats] } }

Invariants: log stride 10 iterations plus iteration 0 of every round; the
round index is 1-based; a new round starts at the last logged iteration + 1;
loss_global = Σ weight_i · raw_i over the training losses.  The file format
is the JAX package's, so either package loads the other's histories.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

LOG_STRIDE = 10


class History:
    def __init__(self):
        self.iters: List[int] = []
        self.rounds_idx: List[int] = []
        self.iter_round: List[int] = []
        self.loss_global: List[float] = []
        self.losses: Dict[str, dict] = {}
        self.losses_test: Dict[str, dict] = {}
        self.round_names: List[str] = []
        self.round_starts: List[int] = []
        self.wall_times: List[float] = []  # per-round wall-clock seconds (new)

    # -- round / entry management ------------------------------------------
    def register_losses(self, train_losses: Sequence, test_losses: Sequence):
        for loss in train_losses:
            if loss.name not in self.losses:
                self.losses[loss.name] = {**loss.metadata(), "log": []}
        for loss in test_losses:
            if loss.name not in self.losses_test:
                self.losses_test[loss.name] = {**loss.metadata(), "log": []}

    @property
    def current_round(self) -> int:
        return len(self.round_names)

    def start_round(self, name: str) -> int:
        """Begin a new optimizer round; returns its global-iteration offset."""
        offset = 0 if not self.iters else self.iters[-1] + 1
        self.round_names.append(name)
        self.round_starts.append(offset)
        self.wall_times.append(0.0)
        return offset

    def append(
        self,
        iter_in_round: int,
        loss_global: float,
        train_values: Dict[str, float],
        test_values: Dict[str, float],
    ) -> None:
        offset = self.round_starts[-1]
        self.iters.append(offset + int(iter_in_round))
        self.rounds_idx.append(self.current_round)  # 1-based
        self.iter_round.append(int(iter_in_round))
        self.loss_global.append(float(loss_global))
        for name, entry in self.losses.items():
            entry["log"].append(float(train_values[name]))
        for name, entry in self.losses_test.items():
            entry["log"].append(float(test_values[name]))

    def add_wall_time(self, seconds: float) -> None:
        if self.wall_times:
            self.wall_times[-1] += float(seconds)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "log": {
                "iter": list(self.iters),
                "round": list(self.rounds_idx),
                "iter_round": list(self.iter_round),
                "loss_global": list(self.loss_global),
            },
            "losses": {k: dict(v) for k, v in self.losses.items()},
            "losses_test": {k: dict(v) for k, v in self.losses_test.items()},
            "log_rounds": {
                "rounds": list(self.round_names),
                "iteration_start": list(self.round_starts),
                "wall_time_seconds": list(self.wall_times),
            },
        }

    def save(self, path) -> None:
        path = str(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # atomic replace: the periodic flush is the crash-recovery mechanism
        # (SURVEY.md §5.3), so a crash mid-write must never corrupt the
        # previous good history
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        os.replace(tmp, path)

    @classmethod
    def from_dict(cls, d: dict) -> "History":
        h = cls()
        h.iters = list(d["log"]["iter"])
        h.rounds_idx = list(d["log"]["round"])
        h.iter_round = list(d["log"]["iter_round"])
        h.loss_global = list(d["log"]["loss_global"])
        h.losses = {k: dict(v) for k, v in d.get("losses", {}).items()}
        h.losses_test = {k: dict(v) for k, v in d.get("losses_test", {}).items()}
        rounds = d.get("log_rounds", {})
        h.round_names = list(rounds.get("rounds", []))
        h.round_starts = list(rounds.get("iteration_start", []))
        h.wall_times = list(
            rounds.get("wall_time_seconds", [0.0] * len(h.round_names))
        )
        return h

    @classmethod
    def load(cls, path) -> "History":
        with open(path) as f:
            return cls.from_dict(json.load(f))
