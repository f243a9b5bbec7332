"""Native 2D triangulation of contour-bounded domains (gmsh replacement).

The reference hands polygon loops to gmsh for the inlet cross-section
meshes (reference NavierStokes/image2inlet.py:141-218) and the channel
cross-section (image2gmsh3D.py:164-488).  Here the same domains are meshed
natively: boundary loops are resampled at the target size, interior points
come from a hexagonal lattice (Lloyd-smoothed), scipy's Delaunay provides
the topology, and triangles are classified into regions by centroid
point-in-polygon tests.  Boundary edges are verified to be recovered and
reinforced with midpoints if not (contours are smooth after the FFT+RDP
pass, so one round almost always suffices).

Regions for the channel cross-section (annulus images):
  0 = outer flow (square minus outer contour)
  1 = splitter band (between contours; solid for x < x_extrude)
  2 = inner flow (inside inner contour)
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
from scipy.spatial import Delaunay, cKDTree

from .core import SimplexMesh


def polygon_area(loop: np.ndarray) -> float:
    x, y = loop[:, 0], loop[:, 1]
    return 0.5 * float(
        np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def points_in_polygon(pts: np.ndarray, loop: np.ndarray) -> np.ndarray:
    """Vectorized crossing-number test. loop: closed polygon (no repeat)."""
    x, y = pts[:, 0], pts[:, 1]
    x0, y0 = loop[:, 0], loop[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    inside = np.zeros(len(pts), dtype=bool)
    for i in range(len(loop)):
        cond = ((y0[i] > y) != (y1[i] > y))
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x0[i] + (y - y0[i]) / (y1[i] - y0[i]) * (x1[i] - x0[i])
        inside ^= cond & (x < xint)
    return inside


def _corner_mask(loop: np.ndarray, angle_deg: float = 30.0) -> np.ndarray:
    """Vertices where the polyline turns by more than angle_deg."""
    a = loop - np.roll(loop, 1, axis=0)
    b = np.roll(loop, -1, axis=0) - loop
    na = np.linalg.norm(a, axis=1)
    nb = np.linalg.norm(b, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        cosang = np.einsum("ij,ij->i", a, b) / np.maximum(na * nb, 1e-300)
    return np.degrees(np.arccos(np.clip(cosang, -1, 1))) > angle_deg


def resample_loop(loop: np.ndarray, lc: float) -> np.ndarray:
    """Resample a closed polyline to ~lc spacing by arc length.

    Sharp corners (turning angle > 30 deg — the RDP output's real features,
    e.g. the Plus shape) are preserved exactly; smooth stretches between
    them are resampled evenly, avoiding the sliver triangles that clusters
    of near-duplicate boundary points cause in the Delaunay step.
    """
    n = len(loop)
    corners = np.nonzero(_corner_mask(loop))[0]
    if len(corners) == 0:
        corners = np.array([0])
    out = []
    for ci in range(len(corners)):
        i0 = corners[ci]
        i1 = corners[(ci + 1) % len(corners)]
        span = (i1 - i0) % n
        if span == 0:
            span = n                       # single corner: whole loop
        idx = np.arange(i0, i0 + span + 1) % n
        if len(idx) < 2:
            out.append(loop[i0][None, :])
            continue
        chain = loop[idx]
        seg = np.linalg.norm(np.diff(chain, axis=0), axis=1)
        s = np.concatenate([[0.0], np.cumsum(seg)])
        L = s[-1]
        k = max(1, int(np.round(L / lc)))
        t = np.linspace(0.0, L, k + 1)[:-1]     # drop endpoint (next corner)
        xs = np.interp(t, s, chain[:, 0])
        ys = np.interp(t, s, chain[:, 1])
        out.append(np.stack([xs, ys], axis=1))
    return np.concatenate(out, axis=0)


def _hex_lattice(lo, hi, lc) -> np.ndarray:
    dy = lc * np.sqrt(3) / 2
    ys = np.arange(lo[1] + dy, hi[1] - 0.25 * dy, dy)
    rows = []
    for j, y in enumerate(ys):
        off = 0.5 * lc if j % 2 else 0.0
        xs = np.arange(lo[0] + 0.5 * lc + off, hi[0] - 0.25 * lc, lc)
        rows.append(np.stack([xs, np.full_like(xs, y)], axis=1))
    if not rows:
        return np.zeros((0, 2))
    return np.concatenate(rows, axis=0)


@dataclasses.dataclass
class TriMesh2D:
    mesh: SimplexMesh            # triangle mesh (points (n,2))
    regions: np.ndarray          # (n_cells,) int region labels
    loops: List[np.ndarray]      # resampled boundary loops (point coords)
    loop_node_ids: List[np.ndarray]  # node indices of each loop's points


def _delaunay_conforming(
    boundary_pts: List[np.ndarray],
    interior: np.ndarray,
    max_rounds: int = 6,
) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Delaunay triangulation whose edge set contains all boundary loop
    edges; missing edges are reinforced with midpoints.

    Returns (points, triangles, loop_node_ids).
    """
    loops = [b.copy() for b in boundary_pts]
    for _ in range(max_rounds):
        counts = [len(b) for b in loops]
        nb = sum(counts)
        pts = np.concatenate(loops + [interior], axis=0)
        tri = Delaunay(pts)
        simplices = tri.simplices
        keyset = _edge_keys(simplices, len(pts))
        offs = np.cumsum([0] + counts)
        ok = True
        new_loops = []
        for li, loop in enumerate(loops):
            ids = np.arange(offs[li], offs[li + 1], dtype=np.int64)
            a = ids
            b = np.roll(ids, -1)
            q = np.minimum(a, b) * len(pts) + np.maximum(a, b)
            missing = np.nonzero(~_keys_in(q, keyset))[0]
            if len(missing):
                ok = False
                aug = []
                mset = set(missing.tolist())
                for i in range(len(loop)):
                    aug.append(loop[i])
                    if i in mset:
                        aug.append(0.5 * (loop[i] + loop[(i + 1) % len(loop)]))
                new_loops.append(np.array(aug))
            else:
                new_loops.append(loop)
        if ok:
            loop_ids = [np.arange(offs[i], offs[i + 1])
                        for i in range(len(loops))]
            return pts, simplices.astype(np.int32), loop_ids
        loops = new_loops
    raise RuntimeError("boundary edge recovery failed after max_rounds")


def _edge_keys(simplices: np.ndarray, n: int) -> np.ndarray:
    e = np.concatenate(
        [simplices[:, [0, 1]], simplices[:, [1, 2]], simplices[:, [0, 2]]])
    e = np.sort(e, axis=1).astype(np.int64)
    return np.unique(e[:, 0] * n + e[:, 1])


def _keys_in(q: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(sorted_keys, q)
    pos = np.clip(pos, 0, len(sorted_keys) - 1)
    return sorted_keys[pos] == q


def _lloyd_smooth(pts, simplices, fixed_mask, iters=4):
    """A few rounds of barycentric smoothing on free nodes."""
    n = len(pts)
    for _ in range(iters):
        acc = np.zeros((n, 2))
        cnt = np.zeros(n)
        for a, b in ((0, 1), (1, 2), (2, 0)):
            np.add.at(acc, simplices[:, a], pts[simplices[:, b]])
            np.add.at(cnt, simplices[:, a], 1)
            np.add.at(acc, simplices[:, b], pts[simplices[:, a]])
            np.add.at(cnt, simplices[:, b], 1)
        new = acc / np.maximum(cnt, 1)[:, None]
        pts = np.where(fixed_mask[:, None], pts, new)
        simplices = Delaunay(pts).simplices
    return pts, simplices


def triangulate_cross_section(
    inner: np.ndarray,
    outer: np.ndarray,
    lc: float,
    half_width: float = 0.5,
    smooth_iters: int = 4,
) -> TriMesh2D:
    """Mesh the full [-hw, hw]^2 square conforming to both contours.

    Contour arrays are in mesh coordinates (y, z) = (col-normalized,
    row-normalized-flipped), i.e. loop[:, 0] is the reference's
    ``point[:, 1]`` plot axis.  Region labels per the module docstring.
    """
    hw = half_width
    square = np.array([[-hw, -hw], [hw, -hw], [hw, hw], [-hw, hw]])
    loops = [
        resample_loop(square, lc),
        resample_loop(outer, lc),
        resample_loop(inner, lc),
    ]
    interior = _hex_lattice((-hw, -hw), (hw, hw), lc)
    # keep interior points clear of boundaries
    tree = cKDTree(np.concatenate(loops, axis=0))
    d, _ = tree.query(interior)
    interior = interior[d > 0.6 * lc]

    pts, simplices, loop_ids = _delaunay_conforming(loops, interior)
    fixed = np.zeros(len(pts), dtype=bool)
    fixed[: sum(len(l) for l in loops)] = True
    if smooth_iters:
        spts, ssimp = _lloyd_smooth(pts.copy(), simplices, fixed, smooth_iters)
        # keep smoothing only if every boundary edge survived re-Delaunay
        keyset = _edge_keys(ssimp, len(spts))
        ok = True
        for ids in loop_ids:
            a = ids.astype(np.int64)
            b = np.roll(a, -1)
            q = np.minimum(a, b) * len(spts) + np.maximum(a, b)
            if not _keys_in(q, keyset).all():
                ok = False
                break
        if ok:
            pts, simplices = spts, ssimp

    cent = pts[simplices].mean(axis=1)
    in_outer = points_in_polygon(cent, outer)
    in_inner = points_in_polygon(cent, inner)
    regions = np.where(in_inner, 2, np.where(in_outer, 1, 0)).astype(np.int32)
    msh = SimplexMesh("triangle", pts, simplices).orient_positive()
    return TriMesh2D(msh, regions, loops, loop_ids)


def triangulate_polygon(loop: np.ndarray, lc: float,
                        smooth_iters: int = 4) -> SimplexMesh:
    """Mesh the interior of a closed polygon (the inner inlet mesh,
    reference image2inlet.py:190-218)."""
    bpts = resample_loop(loop, lc)
    interior = _hex_lattice(loop.min(axis=0), loop.max(axis=0), lc)
    inside = points_in_polygon(interior, loop)
    tree = cKDTree(bpts)
    d, _ = tree.query(interior)
    interior = interior[inside & (d > 0.6 * lc)]
    pts, simplices, loop_ids = _delaunay_conforming([bpts], interior)
    fixed = np.zeros(len(pts), dtype=bool)
    fixed[: len(bpts)] = True
    if smooth_iters:
        spts, ssimp = _lloyd_smooth(pts.copy(), simplices, fixed, smooth_iters)
        keyset = _edge_keys(ssimp, len(spts))
        ids = loop_ids[0].astype(np.int64)
        q = (np.minimum(ids, np.roll(ids, -1)) * len(spts)
             + np.maximum(ids, np.roll(ids, -1)))
        if _keys_in(q, keyset).all():
            pts, simplices = spts, ssimp
    cent = pts[simplices].mean(axis=1)
    keep = points_in_polygon(cent, loop)
    return SimplexMesh("triangle", pts, simplices[keep]).orient_positive()


def triangulate_square_minus(
    hole: np.ndarray, lc: float, half_width: float = 0.5,
    smooth_iters: int = 4,
) -> SimplexMesh:
    """Mesh the square minus a polygonal hole (the outer inlet mesh,
    reference image2inlet.py:141-188: unit square with the outer contour
    as an interior hole)."""
    hw = half_width
    square = np.array([[-hw, -hw], [hw, -hw], [hw, hw], [-hw, hw]])
    loops = [resample_loop(square, lc), resample_loop(hole, lc)]
    interior = _hex_lattice((-hw, -hw), (hw, hw), lc)
    outside = ~points_in_polygon(interior, hole)
    tree = cKDTree(np.concatenate(loops))
    d, _ = tree.query(interior)
    interior = interior[outside & (d > 0.6 * lc)]
    pts, simplices, loop_ids = _delaunay_conforming(loops, interior)
    fixed = np.zeros(len(pts), dtype=bool)
    fixed[: sum(len(l) for l in loops)] = True
    if smooth_iters:
        spts, ssimp = _lloyd_smooth(pts.copy(), simplices, fixed, smooth_iters)
        keyset = _edge_keys(ssimp, len(spts))
        ok = True
        for ids in loop_ids:
            a = ids.astype(np.int64)
            b = np.roll(a, -1)
            q = np.minimum(a, b) * len(spts) + np.maximum(a, b)
            if not _keys_in(q, keyset).all():
                ok = False
                break
        if ok:
            pts, simplices = spts, ssimp
    cent = pts[simplices].mean(axis=1)
    keep = ~points_in_polygon(cent, hole)
    msh = SimplexMesh("triangle", pts, simplices[keep]).orient_positive()
    # drop nodes strictly inside the hole
    used = np.unique(msh.cells.ravel())
    remap = -np.ones(msh.n_nodes, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return SimplexMesh("triangle", msh.points[used],
                       remap[msh.cells].astype(np.int32))


def _loop_lc(loop: np.ndarray) -> float:
    """Median edge length of a polygon loop (guards against resampling a
    coarse RDP loop coarser than its own features)."""
    d = np.linalg.norm(np.roll(loop, -1, axis=0) - loop, axis=1)
    return float(np.median(d))


def triangulate_region(
    tri: TriMesh2D, region: int
) -> Tuple[SimplexMesh, np.ndarray]:
    """Extract one region as a standalone mesh with compacted node ids.

    Returns (mesh, parent_node_ids); all boundary nodes of the submesh are
    wall nodes for the inlet Poisson solve (reference
    image2inlet.py:263-265 marks every boundary facet no-slip).
    """
    keep = tri.regions == region
    cells = tri.mesh.cells[keep]
    used = np.unique(cells.ravel())
    remap = -np.ones(tri.mesh.n_nodes, dtype=np.int64)
    remap[used] = np.arange(len(used))
    sub = SimplexMesh("triangle", tri.mesh.points[used],
                      remap[cells].astype(np.int32))
    return sub, used
