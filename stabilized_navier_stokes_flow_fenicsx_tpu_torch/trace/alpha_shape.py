"""Alpha shapes and the outlet-region expansion.

Replaces the ``alphashape``/shapely dependency (reference
NavierStokes/streamtrace.py:259, 292-343): an alpha shape is the union of
Delaunay simplices with circumradius < 1/alpha; its boundary edges chain
into polygons, and the largest-area polygon is the one the reference
extracts from Multi/GeometryCollection results (:302-312).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import Delaunay


def _circumradius(pts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    a = pts[tris[:, 0]]
    b = pts[tris[:, 1]]
    c = pts[tris[:, 2]]
    la = np.linalg.norm(b - c, axis=1)
    lb = np.linalg.norm(a - c, axis=1)
    lc = np.linalg.norm(a - b, axis=1)
    area = 0.5 * np.abs(
        (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
        - (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1]))
    return la * lb * lc / np.maximum(4.0 * area, 1e-300)


def alpha_shape_polygon(points: np.ndarray, alpha: float = 0.2) -> np.ndarray:
    """Largest boundary polygon of the alpha shape of 2D points.

    Returns a closed loop (m, 2) without repeating the first point.
    Falls back to the convex hull when alpha keeps nothing.
    """
    pts = np.asarray(points, dtype=np.float64)
    tri = Delaunay(pts)
    keep = _circumradius(pts, tri.simplices) < 1.0 / alpha
    simp = tri.simplices[keep]
    if len(simp) == 0:
        hull_idx = tri.convex_hull
        # chain hull edges
        return _chain_largest(pts, hull_idx)
    edges = np.concatenate(
        [simp[:, [0, 1]], simp[:, [1, 2]], simp[:, [2, 0]]])
    es = np.sort(edges, axis=1)
    uniq, counts = np.unique(es, axis=0, return_counts=True)
    boundary = uniq[counts == 1]
    return _chain_largest(pts, boundary)


def _chain_largest(pts: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Chain undirected edges into loops; return the largest-|area| loop."""
    from collections import defaultdict

    adj = defaultdict(list)
    for a, b in edges:
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    visited = set()
    best = None
    best_area = -1.0
    for start in adj:
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        cur, prev = start, -1
        while True:
            nxt = None
            for n in adj[cur]:
                if n != prev and n not in visited:
                    nxt = n
                    break
            if nxt is None:
                # try closing back to start
                break
            loop.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        if len(loop) >= 3:
            P = pts[loop]
            area = 0.5 * abs(np.sum(
                P[:, 0] * np.roll(P[:, 1], -1)
                - np.roll(P[:, 0], -1) * P[:, 1]))
            if area > best_area:
                best_area = area
                best = P
    if best is None:
        raise ValueError("alpha shape produced no closed polygon")
    return best


def expand_bbox(x: np.ndarray, y: np.ndarray, blurr: float = 0.2
                ) -> Tuple[float, float, float, float]:
    """The reference's outward push of polygon extremes
    (streamtrace.py:317-343): min/max of each axis moved out by 20%,
    with the sign-dependent branch preserved verbatim."""
    x = np.asarray(x, dtype=np.float64).copy()
    y = np.asarray(y, dtype=np.float64).copy()
    for arr in (x, y):
        if arr.min() <= 0 and arr.max() >= 0:
            i = int(np.argmin(arr))
            arr[i] = -abs(arr[i] * blurr) + -abs(arr[i])
            j = int(np.argmax(arr))
            arr[j] = arr[j] * blurr + arr[j]
        else:
            i = int(np.argmin(arr))
            arr[i] = -arr[i] * blurr + arr[i]
            j = int(np.argmax(arr))
            arr[j] = arr[j] * blurr + arr[j]
    return float(x.min()), float(x.max()), float(y.min()), float(y.max())
