"""Synthetic inlet images (annulus-style, like the reference's InletImages)."""

from __future__ import annotations

import numpy as np


def make_annulus_image(path: str, shape: str = "circle", size: int = 512,
                       r_inner: float = 0.23, r_outer: float = 0.32) -> str:
    """Write a black ring (splitter wall) on white: the two-contour input
    format the reference pipeline expects (e.g. InletImages/Circle.png)."""
    from PIL import Image

    n = size
    yy, xx = np.meshgrid(
        np.linspace(-0.5, 0.5, n), np.linspace(-0.5, 0.5, n), indexing="ij")
    if shape == "circle":
        r = np.hypot(xx, yy)
    elif shape == "square":
        r = np.maximum(np.abs(xx), np.abs(yy))
    elif shape == "plus":
        a = 0.4
        inside = (np.abs(xx) < a * r_inner) | (np.abs(yy) < a * r_inner)
        d = np.where(inside, np.maximum(np.abs(xx), np.abs(yy)) * 0.7,
                     np.hypot(xx, yy) * 1.4)
        r = d
    else:
        raise ValueError(shape)
    ring = (r >= r_inner) & (r <= r_outer)
    img = np.where(ring, 0, 255).astype(np.uint8)
    Image.fromarray(img, "L").save(path)
    return path
