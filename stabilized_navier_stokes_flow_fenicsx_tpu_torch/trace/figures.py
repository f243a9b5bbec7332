"""Streamtrace figures + CSV outputs (reference streamtrace.py:448-534).

The three figures are written as SVG text: each draws its points in a
square frame of +-``limits`` without ticks, under the reference's
title, in the reference's default colour.  Scatter markers are the
``<circle>`` elements of the ``<g id="scatter">`` group, one a point.
``save_trace_figures`` is the span ``figures`` (utils/profiling.py)."""

from __future__ import annotations

import os
from xml.sax.saxutils import escape

import numpy as np

from ..utils.profiling import traced

SIZE, MARGIN = 432.0, 36.0       # canvas and frame margin, in points
COLOR = "#1f77b4"


def _pixels(points: np.ndarray, limits: float) -> np.ndarray:
    scale = (SIZE - 2 * MARGIN) / (2 * limits)
    p = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    return np.column_stack([MARGIN + (p[:, 0] + limits) * scale,
                            SIZE - MARGIN - (p[:, 1] + limits) * scale])


def _write_svg(path: str, limits: float, title: str, body: str) -> None:
    side = SIZE - 2 * MARGIN
    frame = (f'x="{MARGIN:g}" y="{MARGIN:g}" width="{side:g}" '
             f'height="{side:g}"')
    head = (f'<text x="{SIZE / 2:g}" y="{MARGIN - 10:g}" '
            f'text-anchor="middle" font-family="sans-serif" '
            f'font-size="12">{escape(title)}</text>\n' if title else "")
    with open(path, "w") as f:
        f.write(
            f'<?xml version="1.0" encoding="utf-8"?>\n'
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{SIZE:g}pt" '
            f'height="{SIZE:g}pt" viewBox="0 0 {SIZE:g} {SIZE:g}">\n'
            f'<rect width="{SIZE:g}" height="{SIZE:g}" fill="white"/>\n'
            f'<clipPath id="frame"><rect {frame}/></clipPath>\n'
            f'<g clip-path="url(#frame)">\n{body}</g>\n'
            f'<rect {frame} fill="none" stroke="black" '
            f'stroke-width="0.8"/>\n{head}</svg>\n')


def _scatter(points: np.ndarray, limits: float, r: float) -> str:
    circles = "".join(f'<circle cx="{x:.2f}" cy="{y:.2f}" r="{r:g}"/>\n'
                      for x, y in _pixels(points, limits))
    return f'<g id="scatter" fill="{COLOR}">\n{circles}</g>\n'


@traced("figures")
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
    contour = " ".join(f"{x:.2f},{y:.2f}"
                       for x, y in _pixels(result.inner_contour, limits))
    _write_svg(os.path.join(folder, "inner_contour.svg"), limits,
               "Inner Contour",
               f'<polygon id="contour" points="{contour}" fill="{COLOR}"/>\n')
    _write_svg(os.path.join(folder, "inner_mesh.svg"), limits,
               "Inner Contour Mesh", _scatter(seed_points[:, :2], limits, 3))

    img_name = os.path.basename(img_fname)
    if img_name.endswith(".png"):
        img_name = img_name[:-4]
    _write_svg(os.path.join(folder, f"rev_trace_{img_name}_{num_seeds}.svg"),
               limits, "", _scatter(result.outlet_points, limits, 1.5))

    np.savetxt(os.path.join(folder, "rev_seeds.csv"),
               result.seeds, delimiter=",")
    np.savetxt(os.path.join(folder, "final_output.csv"),
               result.outlet_points, delimiter=",")
