"""Contact-map heatmap with chromosome outlines.

Capability parity with plotContactMaps.py:15-91: plasma colormap
(optionally reversed), percentile-clipped color range, Mb-labeled ticks,
white group outlines from cut indices, Agg backend, save-to-png, and
interactive display via ``show_plot`` (plotContactMaps.py:86-88 —
notebook real-time viewing, orderGenome.py:600).  Implemented directly
on matplotlib (the reference's xarray wrapper adds nothing here).
The backend defaults to Agg (headless hosts); when
``show_plot=True`` is requested under Agg, ``plt.show()`` is still
called — matplotlib makes it a warning no-op — so notebook/GUI
deployments that pre-select an interactive backend get the reference
behavior without this module fighting their choice.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import os

import matplotlib

_INTERACTIVE_BACKENDS = (
    "qtagg", "qt5agg", "qt6agg", "tkagg", "gtk3agg", "gtk4agg", "wxagg",
    "macosx", "webagg", "nbagg",
    "module://matplotlib_inline.backend_inline",
    "module://ipympl.backend_nbagg",
)
if (
    not os.environ.get("MPLBACKEND")  # an explicit env choice wins
    and matplotlib.get_backend().lower() not in _INTERACTIVE_BACKENDS
):
    matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def plot_contact_map(
    adj_mat: np.ndarray,
    resolution: int = 100_000,
    tick_count: int = 11,
    highlight_chroms: Optional[Sequence[int]] = None,
    w_inches: float = 32,
    h_inches: float = 32,
    low_pct: float = 1,
    high_pct: float = 98,
    reverse_color_map: str = "_r",
    show_plot: bool = False,
    save_plot: Optional[str] = None,
    title: Optional[str] = None,
    title_suffix: Optional[str] = None,
) -> None:
    """Render and optionally save/display the heatmap.

    ``reverse_color_map='_r'`` (plasma_r) suits distance matrices;
    ``''`` suits similarity matrices (plotContactMaps.py:28).
    ``show_plot`` mirrors plotContactMaps.py:86-88: display the figure
    interactively (a no-op warning under the headless Agg backend).
    """
    adj_mat = np.asarray(adj_mat)
    n = len(adj_mat)
    start = time.time()
    fig, ax = plt.subplots()
    fig.set_size_inches(w_inches, h_inches)
    ax.pcolormesh(
        np.arange(n + 1),
        np.arange(n + 1),
        adj_mat[::-1],
        cmap="plasma" + reverse_color_map,
        vmin=np.percentile(adj_mat, low_pct),
        vmax=np.percentile(adj_mat, high_pct),
    )
    if highlight_chroms:
        prev = 0
        for index in highlight_chroms:
            ax.plot([prev, index], [n - prev, n - prev], color="white")
            ax.plot([prev, index], [n - index, n - index], color="white")
            ax.plot([prev, prev], [n - index, n - prev], color="white")
            ax.plot([index, index], [n - index, n - prev], color="white")
            prev = index
        ax.plot([prev, n], [n - prev, n - prev], color="white")
        ax.plot([prev, prev], [0, n - prev], color="white")

    tick_dist = n / tick_count
    ticks = [0.0]
    acc = 0.0
    for _ in range(tick_count - 1):
        acc += tick_dist
        ticks.append(acc)
    ticks.append(float(n))
    ax.set_xticks(ticks)
    ax.set_xticklabels(
        [f"{int((t * resolution) / 1_000_000)} Mb" for t in ticks], size=18
    )
    ax.set_xlabel("")
    yticks = ticks[1:]
    ax.set_yticks(yticks)
    ax.set_yticklabels(
        [f"{int((t * resolution) / 1_000_000)} Mb" for t in yticks], size=18
    )
    ax.set_ylabel("")
    if title:
        if title_suffix:
            title = title + title_suffix
        ax.set_title(title, size=25)
    if save_plot:
        plt.savefig(save_plot)
    if show_plot:
        plt.show()
    plt.close(fig)
    print("Time to rearrange matrix and plot " + str(time.time() - start))
