"""Utility surface: ``ns.utils.{save_json, load_json, plot_history,
HistoryPlotCallback, CheckpointCallback}``.

matplotlib is imported only inside the function that draws a history: the
card's host has none, and a plot that fails never stops a training run.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np


def has_module(name: str) -> bool:
    """Whether ``name`` can be imported here (h5py and matplotlib are
    optional: the card's host has neither)."""
    return importlib.util.find_spec(name) is not None


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def save_json(obj, path) -> None:
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def _plot_history_dict(history: dict, filename=None, gui: bool = False):
    """Draw a history (``History.to_dict()`` layout) as the loss-trend
    figure; saved to ``filename`` when given."""
    import matplotlib

    if not gui:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    iters = history["log"]["iter"]
    ax.plot(iters, history["log"]["loss_global"], "k-", linewidth=2,
            label="global")
    for group, style in (("losses", "-"), ("losses_test", "--")):
        for name, entry in history.get(group, {}).items():
            ax.plot(iters, entry["weight"] * np.asarray(entry["log"]), style,
                    linewidth=1.0, label=name)
    rounds = history.get("log_rounds", {})
    for rname, start in zip(rounds.get("rounds", []),
                            rounds.get("iteration_start", [])):
        ax.axvline(start, color="gray", alpha=0.5)
        ax.text(max(start, 1), 0.3, rname, rotation=90,
                bbox={"facecolor": "lightgray", "alpha": 0.7,
                      "edgecolor": "black", "pad": 3})
    ax.set_xscale("symlog", linthresh=100, linscale=1)
    ax.set_yscale("log")
    ax.grid()
    ax.set_xlabel("# Iterations", fontsize=15)
    ax.set_ylabel("Losses Values", fontsize=15)
    ax.legend(loc=1, fontsize=9)
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    elif gui:
        plt.show()
    return fig


def plot_history(path, filename=None, gui: bool = False):
    """Render a saved History_Loss.json to a loss-trend figure (PNG beside
    the file unless ``filename`` is given)."""
    history = load_json(path)
    if filename is None and not gui:
        filename = os.path.splitext(str(path))[0] + ".png"
    return _plot_history_dict(history, filename=filename, gui=gui)


class _RateCallback:
    """Fires every ``frequency`` iterations by rate, not by alignment: a
    resumed round starts at any global offset, where ``iteration %
    frequency == 0`` may never meet a log point.  ``force`` always fires."""

    def __init__(self, frequency: int):
        self.frequency = int(frequency)
        self._last_fired = None

    def _due(self, iteration: int, force: bool) -> bool:
        if not force and (self.frequency <= 0 or (
                self._last_fired is not None
                and iteration - self._last_fired < self.frequency)):
            return False
        self._last_fired = iteration
        return True


class CheckpointCallback(_RateCallback):
    """Writes the parameters, the last round's optimizer state and the
    history cursor to ``path`` (``checkpoint.save_checkpoint``); restore
    with ``checkpoint.load_checkpoint``."""

    def __init__(self, path, frequency: int = 100):
        super().__init__(frequency)
        self.path = str(path)

    def __call__(self, pb, iteration: int, force: bool = False) -> None:
        if not self._due(iteration, force):
            return
        from tpinn_torch.checkpoint import save_checkpoint

        save_checkpoint(self.path, pb.model.params,
                        opt_state=pb.last_opt_state,
                        extra={"iteration": iteration,
                               "rounds": list(pb.history.round_names),
                               "round_name": pb.last_round_name})


class HistoryPlotCallback(_RateCallback):
    """Rewrites the history JSON (``filename_history``) and redraws the
    loss-trend figure (``filename``); a failed plot, such as on a host
    without matplotlib, is ignored, the history flush is not."""

    def __init__(self, frequency: int = 100, gui: bool = False,
                 filename=None, filename_history=None, plot: bool = True):
        super().__init__(frequency)
        self.gui = gui
        self.filename = filename
        self.filename_history = filename_history
        self.plot = plot

    def __call__(self, pb, iteration: int, force: bool = False) -> None:
        if not self._due(iteration, force):
            return
        if self.filename_history:
            pb.history.save(self.filename_history)
        if self.plot and self.filename:
            try:
                _plot_history_dict(pb.history.to_dict(),
                                   filename=self.filename, gui=False)
            except Exception:
                pass  # plotting must never stop a training run
