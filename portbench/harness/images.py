"""Inlet images: a black ring (the splitter wall) on white.

A frozen copy of the port's ``utils/testimg.py::make_annulus_image``
(circle only), so that the benchmark's inputs stay put when the program
changes.  ``SHAPES`` names what it draws; a traffic file that asks for
another shape is refused (a square or a plus needs its drawing here and
its outlet test in ``judge.py``).  ``inner_circle`` gives the ring's
inner edge in the mesh's (y, z) coordinates, which the reference uses to
judge the outlet points; ``region_areas`` the areas the image's pixels
give the inlets and the splitter, against which the served meshes are
judged.
"""

from __future__ import annotations

import numpy as np

SHAPES = ("circle",)


def ring_mask(size: int, r_inner: float, r_outer: float) -> np.ndarray:
    """(ring, inside) pixel masks of the ring r_inner <= r <= r_outer (in
    units of the image side, centred) and of the disk it encloses."""
    yy, xx = np.meshgrid(np.linspace(-0.5, 0.5, size),
                         np.linspace(-0.5, 0.5, size), indexing="ij")
    r = np.hypot(xx, yy)
    return (r >= r_inner) & (r <= r_outer), r < r_inner


def make_annulus_image(path: str, size: int, r_inner: float,
                       r_outer: float) -> str:
    """Write the ring as a grayscale PNG and return ``path``."""
    from PIL import Image

    ring, _ = ring_mask(size, r_inner, r_outer)
    Image.fromarray(np.where(ring, 0, 255).astype(np.uint8), "L").save(path)
    return path


def region_areas(size: int, r_inner: float, r_outer: float,
                 half_width: float = 0.5):
    """(inner inlet, outer inlet, splitter cross-section) areas in mesh
    units by the image's pixels: a pixel is a square of side 1 / size on
    the mesh (``inner_circle``), and the contour at level 0.5 runs
    between the pixel centres, so a region's area is its pixel count.
    The outer inlet is the channel's square less the ring and the disk."""
    ring, inside = ring_mask(size, r_inner, r_outer)
    px = 1.0 / size ** 2
    a_in, a_ring = inside.sum() * px, ring.sum() * px
    return a_in, (2 * half_width) ** 2 - a_in - a_ring, a_ring


def inner_circle(size: int, r_inner: float):
    """(centre (y, z), radius) of the ring's inner edge in mesh
    coordinates.  Pixel (row, col) sits at xx = col / (size - 1) - 0.5,
    yy = row / (size - 1) - 0.5 in the image and at y = (col - size / 2)
    / size, z = -(row - size / 2) / size on the mesh (the contour
    normalisation of image2inlet.py:58-91)."""
    s = (size - 1) / size
    centre = np.array([(0.5 * (size - 1) - 0.5 * size) / size,
                       -(0.5 * (size - 1) - 0.5 * size) / size])
    return centre, r_inner * s
