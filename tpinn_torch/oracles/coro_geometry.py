"""The parametric stenosis (blob) sketch, a design aid: a sech²-shaped
stenosis bump inside a channel, the bump the ``sten1`` / ``sten2``
parameters of the coronary geometry control
(:mod:`tpinn_torch.oracles.coro_param`).  The figure draws through
:func:`tpinn_torch.viz._plt` (matplotlib, imported there).
"""

from __future__ import annotations

import numpy as np


def stenosis_profile(x, channel_height: float = 10.0, c: float = 0.2):
    """Bump height profile: max_blob·c / (2·cosh²(x√c/2))."""
    x = np.asarray(x, dtype=float)
    max_blob = (channel_height / 3.0) * (2.0 / c)
    r_c = np.sqrt(c)
    return max_blob * c / (2.0 * np.cosh(x * r_c / 2.0) ** 2)


def sketch(length: float = 40.0, height: float = 10.0, c: float = 0.2,
           n: int = 1000, filename=None):
    """The channel and stenosis outline figure."""
    from tpinn_torch.viz import _plt

    plt = _plt()
    xx = np.linspace(-10.0, 10.0, n + 1)
    blob = stenosis_profile(xx, height, c)

    fig = plt.figure(1, figsize=(12, 3))
    ax = fig.add_subplot()
    eps = 0.3
    ax.axis([-length / 2, length / 2, -eps, height + eps])
    ax.axis("equal")
    for x0 in (-length / 2, length / 2):
        ax.axvline(x0, 0, height, c="r")
    for y0 in (0.0, height):
        ax.axhline(y0, -length / 2, length / 2, c="r")
    ax.plot(xx, blob, "k")
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig
