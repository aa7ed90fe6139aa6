"""3D visualisation helpers (reference tools/visulization.py; the port's
copy of ``interpret_quality_tpu/results/visualization.py``): turbo and
red-gray-blue colormaps, per-region colored scatter plots, FPS-centre
viewer.  Needs matplotlib (the ``agg`` backend).
"""
from __future__ import annotations

from typing import Optional, Sequence

import matplotlib

matplotlib.use("agg")
import matplotlib.pyplot as plt
import numpy as np
from matplotlib.colors import LinearSegmentedColormap, Normalize

turbo_cmp = plt.get_cmap("turbo")

red_gray_blue_cmp = LinearSegmentedColormap.from_list(
    "red_gray_blue", ["#d73027", "#bdbdbd", "#4575b4"])


def scatter_regions(data: np.ndarray, region_values: np.ndarray,
                    region_id: np.ndarray, out_path: str,
                    title: Optional[str] = None, cmap=turbo_cmp,
                    bound: Optional[Sequence[float]] = None,
                    region_bold: Optional[int] = None, plot_lim: float = 0.57):
    """Scatter a cloud colored by a per-region value (e.g. Shapley values).

    Args:
      data: (N, 3); region_values: (R,); region_id: (N,).
    """
    colors = region_values[region_id]
    if bound is None:
        bound = (colors.min(), colors.max())
    s = np.full(data.shape[0], 2.0)
    if region_bold is not None:
        s[region_id == region_bold] = 10.0
    fig = plt.figure(figsize=(5, 5), dpi=150)
    ax = fig.add_subplot(111, projection="3d")
    sc = ax.scatter(data[:, 0], data[:, 1], data[:, 2], c=colors, marker=".",
                    s=s, alpha=1, cmap=cmap,
                    norm=Normalize(vmin=bound[0], vmax=bound[1]))
    ax.set_xlim(-plot_lim, plot_lim)
    ax.set_ylim(-plot_lim, plot_lim)
    ax.set_zlim(-plot_lim, plot_lim)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.colorbar(sc, ax=ax)
    plt.savefig(out_path)
    plt.close()
    return out_path


def visualize_fps_center(data: np.ndarray, fps_index: np.ndarray,
                         out_path: str, plot_lim: float = 0.57):
    """Cloud with its FPS region centres highlighted."""
    fig = plt.figure(figsize=(5, 5), dpi=150)
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(data[:, 0], data[:, 1], data[:, 2], c="#bdbdbd", marker=".",
               s=2)
    c = data[fps_index]
    ax.scatter(c[:, 0], c[:, 1], c[:, 2], c="red", marker="o", s=30)
    ax.set_xlim(-plot_lim, plot_lim)
    ax.set_ylim(-plot_lim, plot_lim)
    ax.set_zlim(-plot_lim, plot_lim)
    ax.set_axis_off()
    plt.savefig(out_path)
    plt.close()
    return out_path
