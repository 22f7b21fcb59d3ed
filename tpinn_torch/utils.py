"""Utility surface: ``ns.utils.{save_json, load_json, plot_history}``.

matplotlib is imported only inside :func:`plot_history`: the card's host has
none, and nothing on the training path plots.
"""

from __future__ import annotations

import json
import os

import numpy as np


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def save_json(obj, path) -> None:
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def plot_history(path, filename=None, gui: bool = False):
    """Render a saved History_Loss.json to a loss-trend figure (PNG beside
    the file unless ``filename`` is given)."""
    import matplotlib

    if not gui:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    history = load_json(path)
    if filename is None and not gui:
        filename = os.path.splitext(str(path))[0] + ".png"
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
