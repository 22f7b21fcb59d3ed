"""The figures a case writes with its artifacts: the exact-vs-PINN contour
grid (Graphic.jpg; on scattered mesh nodes for the coronary case), the
unsteady case's per-time-slice grids
(Graphic_{i}_of_{n}.jpg) and the grouped loss trend
(Loss_Trend_Reduced.png); and the 3-D exact-vs-PINN scatter of the
hand-rolled cases.

Levels are shared by the exact and the PINN field, rounded outward to
5·10^k; the loss trend draws the global loss and each group's mean
weighted loss on a symlog iteration axis, with the optimizer rounds
marked.  matplotlib is imported only inside :func:`_plt`, when a figure is
drawn: the card's host has none.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def approx_scale(x: float, up: bool) -> float:
    """|x| rounded outward (``up``) or inward to a 5·10^k-aligned level
    bound."""
    if x == 0:
        return 0.0
    factor = np.floor(np.log10(abs(x))) - 1
    if up:
        x = np.ceil(x / np.power(10.0, factor) / 5)
    else:
        x = np.floor(x / np.power(10.0, factor) / 5)
    return float(x * 5 * np.power(10.0, factor))


def shared_levels(exact, pinn, num_levels: int = 11) -> np.ndarray:
    """Contour levels spanning both fields."""
    lo = min(np.min(exact), np.min(pinn))
    hi = max(np.max(exact), np.max(pinn))
    lo, hi = approx_scale(lo, False), approx_scale(hi, True)
    if lo == hi:
        lo, hi = lo - 1e-12, hi + 1e-12
    return np.linspace(lo, hi, num_levels)


def _compare_figure(draw, exact_fields: Sequence, pinn_fields: Sequence,
                    titles: Sequence[str], problem_name: str,
                    filename: Optional[str], num_levels: int):
    """The n×2 exact-vs-PINN figure, each panel drawn by
    ``draw(ax, field, levels)``."""
    plt = _plt()
    n = len(exact_fields)
    fig, axes = plt.subplots(n, 2, figsize=(12, 8))
    if n == 1:
        axes = np.array([axes])
    fig.suptitle(f"Solutions of the {problem_name} problem", fontsize=18,
                 y=0.97, x=0.50)
    for row, (ex, pinn, title) in enumerate(zip(exact_fields, pinn_fields,
                                                titles)):
        levels = shared_levels(ex, pinn, num_levels)
        for col, (field, label) in enumerate(
                [(ex, f"Numerical {title}"), (pinn, f"PINNS {title}")]):
            ax = axes[row][col]
            ax.title.set_text(label)
            fig.colorbar(draw(ax, field, levels), ax=ax)
    plt.tight_layout()
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig


def contour_compare(grid_x, grid_y, exact_fields: Sequence,
                    pinn_fields: Sequence,
                    titles: Sequence[str] = ("u-velocity", "v-velocity",
                                             "Pressure"),
                    problem_name: str = "", filename: Optional[str] = None,
                    num_levels: int = 11):
    """The n×2 exact-vs-PINN contour figure (Graphic.jpg)."""
    return _compare_figure(
        lambda ax, field, levels: ax.contourf(grid_x, grid_y, field,
                                              levels=levels),
        exact_fields, pinn_fields, titles, problem_name, filename,
        num_levels)


def tricontour_compare(x, y, exact_fields: Sequence, pinn_fields: Sequence,
                       titles: Sequence[str] = ("u-velocity", "v-velocity",
                                                "Pressure"),
                       problem_name: str = "",
                       filename: Optional[str] = None,
                       num_levels: int = 11):
    """The same figure on scattered nodes (an unstructured mesh, the
    coronary case), filled contours over their Delaunay triangulation."""
    x, y = np.asarray(x), np.asarray(y)
    return _compare_figure(
        lambda ax, field, levels: ax.tricontourf(x, y, np.asarray(field),
                                                 levels=levels),
        exact_fields, pinn_fields, titles, problem_name, filename,
        num_levels)


def scatter3d_compare(x, y, exact, pinn, filename: Optional[str] = None,
                      labels=("exact solution", "numerical solution")):
    """3-D scatter of the exact and the PINN values over the test points."""
    plt = _plt()
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    for z, label in zip((exact, pinn), labels):
        ax.scatter(_host(x), _host(y), _host(z), label=label)
    ax.legend()
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu()
    return np.asarray(a)


def contour_time_slices(grid_x, grid_y, exact_slices, pinn_slices, times,
                        n_times: int, folder: str,
                        titles: Sequence[str] = ("u-velocity", "v-velocity",
                                                 "Pressure"),
                        num_levels: int = 11) -> List[str]:
    """The unsteady case's per-time-slice exact-vs-PINN contour figures,
    ``Graphic_{i+1}_of_{n}.jpg`` in ``folder``, each field's levels shared
    across every slice.  ``exact_slices`` / ``pinn_slices`` are per-field
    lists of per-slice 2-D arrays."""
    import os

    plt = _plt()
    n_stamps = len(times)
    levels = [shared_levels(np.stack(ex), np.stack(pinn), num_levels)
              for ex, pinn in zip(exact_slices, pinn_slices)]
    paths = []
    for i, t in enumerate(times):
        title = "Solutions when t = {0:.4f}".format(t)
        title += ", time step #{}/{}".format(
            int(i * (n_times / max(n_stamps - 1, 1))), n_times)
        fig, axes = plt.subplots(3, 2, figsize=(12, 8))
        fig.suptitle(title, fontsize=18, y=0.97, x=0.50)
        for row, name in enumerate(titles):
            for col, (field, label) in enumerate(
                    [(exact_slices[row][i], f"Numerical {name}"),
                     (pinn_slices[row][i], f"PINNS {name}")]):
                ax = axes[row][col]
                ax.title.set_text(label)
                cs = ax.contourf(grid_x, grid_y, field, levels=levels[row])
                fig.colorbar(cs, ax=ax)
        plt.tight_layout()
        path = os.path.join(folder, f"Graphic_{i + 1}_of_{n_stamps}.jpg")
        fig.savefig(path)
        plt.close(fig)
        paths.append(path)
    return paths


def plot_loss_groups(history: dict, groups: Dict[str, List[str]],
                     filename: Optional[str] = None,
                     dashed_groups: Sequence[str] = ()):
    """Loss_Trend_Reduced.png: the global loss and, per group, the mean of
    its losses' weighted logs (test groups dashed), symlog-x, rounds
    marked.  A group naming a loss the history lacks is left out."""
    plt = _plt()
    cmap = plt.get_cmap("Set1")
    fig, ax = plt.subplots(figsize=(10, 8))
    iters = history["log"]["iter"]
    ax.plot(iters, history["log"]["loss_global"], "k-", linewidth=2)
    for i, (label, names) in enumerate(groups.items()):
        source = next((key for key in ("losses", "losses_test")
                       if all(n in history.get(key, {}) for n in names)),
                      None)
        if source is None:
            continue
        vals = [history[source][n]["weight"]
                * np.asarray(history[source][n]["log"]) for n in names]
        style = ("--" if label in dashed_groups or source == "losses_test"
                 else "-")
        lw = 3.0 if source == "losses_test" else 1.5
        ax.plot(iters, sum(vals) / len(names), style, color=cmap(i),
                linewidth=lw, label=label)
    rounds = history.get("log_rounds", {})
    for rname, start in zip(rounds.get("rounds", []),
                            rounds.get("iteration_start", [])):
        ax.axvline(start, 0, 1, c=cmap(5))
        ax.text(max(start, 1), 0.3, rname, rotation=90,
                bbox={"facecolor": "lightgray", "alpha": 0.7,
                      "edgecolor": "black", "pad": 3})
    ax.set_xscale("symlog", linthresh=100, linscale=1)
    ax.set_yscale("log")
    ax.legend(loc=1, fontsize=15)
    ax.grid()
    ax.set_xlabel("# Iterations", fontsize=15)
    ax.set_ylabel("Losses Values", fontsize=15)
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig
