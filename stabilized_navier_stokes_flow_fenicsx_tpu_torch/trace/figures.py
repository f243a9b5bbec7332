"""Streamtrace figures + CSV outputs (reference streamtrace.py:448-534)."""

from __future__ import annotations

import os
import numpy as np


def _square_axes(ax, limits: float):
    ax.set_aspect("equal")
    ax.set_xlim(-limits, limits)
    ax.set_ylim(-limits, limits)
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_xticklabels([])
    ax.set_yticklabels([])


def save_trace_figures(
    folder: str,
    img_fname: str,
    result,
    seed_points: np.ndarray,
    num_seeds: int,
    limits: float = 0.5,
) -> None:
    """inner_contour.svg, inner_mesh.svg, rev_trace_*.svg + CSVs
    (reference save_figs, streamtrace.py:498-517)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    contour = result.inner_contour
    fig, ax = plt.subplots()
    ax.fill(contour[:, 0], contour[:, 1])
    _square_axes(ax, limits)
    ax.set_title("Inner Contour")
    fig.savefig(os.path.join(folder, "inner_contour.svg"))
    plt.close(fig)

    fig, ax = plt.subplots()
    ax.scatter(seed_points[:, 0], seed_points[:, 1])
    _square_axes(ax, limits)
    ax.set_title("Inner Contour Mesh")
    fig.savefig(os.path.join(folder, "inner_mesh.svg"))
    plt.close(fig)

    img_name = os.path.basename(img_fname)
    if img_name.endswith(".png"):
        img_name = img_name[:-4]
    fig, ax = plt.subplots()
    op = result.outlet_points
    if len(op):
        ax.scatter(op[:, 0], op[:, 1], marker=".")
    _square_axes(ax, limits)
    fig.savefig(os.path.join(
        folder, f"rev_trace_{img_name}_{num_seeds}.svg"))
    plt.close(fig)

    np.savetxt(os.path.join(folder, "rev_seeds.csv"),
               result.seeds, delimiter=",")
    np.savetxt(os.path.join(folder, "final_output.csv"),
               result.outlet_points, delimiter=",")
