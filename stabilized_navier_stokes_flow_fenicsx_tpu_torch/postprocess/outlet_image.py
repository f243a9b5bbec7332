"""Legacy outlet image (StokesFlow/process_streamtrace.py port).

The reference's earlier pipeline turned the reverse-trace advection data
into a colorized outlet PNG: rasterize the inner inlet shape on a 256^2
grid (reference StokesFlow/image2inlet.py:356-388 / process_streamtrace.py
:61-99), convert per-seed advection vectors into an index permutation map
(:166-196), apply it to the raster (:198-217), and save an RGB image with
the extrudate color (81, 164, 209) (:260-289).

The modern path classifies seeds directly (trace/pipeline.py); these
utilities keep the legacy artifact producible.
"""

from __future__ import annotations

import numpy as np

from ..mesh.tri2d import points_in_polygon

EXTRUDATE_RGB = (81, 164, 209)    # process_streamtrace.py:260-289


def rasterize_inner_shape(contour: np.ndarray, n: int = 256) -> np.ndarray:
    """(n, n) uint8 mask of the inner polygon over [-0.5, 0.5]^2
    (255 inside) — create_inner_shape without the shapely double loop."""
    xs = np.linspace(-0.5, 0.5, n)
    ys = np.linspace(-0.5, 0.5, n)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    inside = points_in_polygon(pts, contour)
    return np.where(inside.reshape(n, n), 255, 0).astype(np.uint8)


def advection_map(seeds: np.ndarray, endpoints: np.ndarray) -> np.ndarray:
    """Per-seed advection vectors (dy, dz): where each outlet-plane seed
    came from at the inlet (reverse_streamtrace_xdmf.py:94-141 analogue)."""
    return seeds[:, 1:3] - endpoints[:, 1:3]


def outlet_image_from_trace(
    seeds: np.ndarray,            # (m, 3) reverse seeds (grid at x=3.9)
    endpoints: np.ndarray,        # (m, 3) backward endpoints
    inner_contour: np.ndarray,    # (k, 2) inlet inner contour (y, z)
    n: int = 256,
    path: str | None = None,
) -> np.ndarray:
    """Colorized outlet image: seed pixels whose backward endpoints land
    inside the inner inlet shape get the extrudate color."""
    inside = points_in_polygon(endpoints[:, 1:3], inner_contour)
    img = np.full((n, n, 3), 255, dtype=np.uint8)
    xs = np.linspace(-0.5, 0.5, n)
    iy = np.clip(np.searchsorted(xs, seeds[:, 1]), 0, n - 1)
    iz = np.clip(np.searchsorted(xs, seeds[:, 2]), 0, n - 1)
    # image row = flipped z so the PNG matches the input-image orientation
    img[(n - 1 - iz)[inside], iy[inside]] = EXTRUDATE_RGB
    if path is not None:
        from PIL import Image

        Image.fromarray(img, "RGB").save(path)
    return img
