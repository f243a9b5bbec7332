"""Graded 2D triangulation from a size field (gmsh Box/Ball-field analogue).

The reference's DFG meshes are generated by gmsh .geo files with nested
Box/Ball refinement fields (reference
NavierStokes/Validation_Flow/dfg_pillar_2D.geo:49-94).  Native equivalent:
dart-throwing point placement against a user size function lc(x) (greedy
acceptance on a uniform hash grid), conforming Delaunay with the domain
loops, then centroid classification.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
from .core import SimplexMesh
from .tri2d import (
    _delaunay_conforming, _edge_keys, _keys_in, _lloyd_smooth,
    points_in_polygon)


def _walk_chain(chain: np.ndarray, lc_fn: Callable) -> np.ndarray:
    """Points along an open polyline at adaptive lc spacing, excluding the
    final endpoint (the next chain starts there)."""
    seg = np.linalg.norm(np.diff(chain, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]

    def at(t):
        i = min(np.searchsorted(s, t, side="right") - 1, len(seg) - 1)
        f = (t - s[i]) / max(seg[i], 1e-300)
        return chain[i] + f * (chain[i + 1] - chain[i])

    pts = []
    t = 0.0
    while t < total:
        p = at(t)
        pts.append(p)
        t += max(float(lc_fn(p[None, :])[0]), 1e-6)
    # drop a sliver point just before the endpoint: the next chain
    # starts AT chain[-1], so a near-coincident final point makes a
    # (near-)zero-length boundary edge that Delaunay edge recovery can
    # never satisfy (observed as an exact duplicate at a rect corner —
    # "boundary edge recovery failed after max_rounds")
    if len(pts) > 1 and np.linalg.norm(pts[-1] - chain[-1]) \
            < 0.4 * float(lc_fn(pts[-1][None, :])[0]):
        pts.pop()
    return np.array(pts)


def resample_loop_field(loop: np.ndarray, lc_fn: Callable) -> np.ndarray:
    """Resample a closed polyline to local spacing lc_fn (refines AND
    coarsens), preserving sharp corners exactly."""
    from .tri2d import _corner_mask

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
            span = n
        idx = np.arange(i0, i0 + span + 1) % n
        out.append(_walk_chain(loop[idx], lc_fn))
    return np.concatenate(out, axis=0)


def dart_points(
    lo: np.ndarray,
    hi: np.ndarray,
    lc_fn: Callable,
    lc_min: float,
    boundary: np.ndarray,
    inside_fn: Callable,
    k_exclusion: float = 0.85,
) -> np.ndarray:
    """Greedy Poisson-disk-style interior points honoring lc_fn.

    Candidates come from a jittered lattice at lc_min resolution, visited
    fine-first; a candidate is accepted if no previously accepted point
    (or boundary point) lies within k_exclusion * lc_fn(candidate).
    """
    rng = np.random.default_rng(12345)
    span = hi - lo
    nx = int(np.ceil(span[0] / lc_min))
    ny = int(np.ceil(span[1] / lc_min))
    X, Y = np.meshgrid(
        lo[0] + (np.arange(nx) + 0.5) * span[0] / nx,
        lo[1] + (np.arange(ny) + 0.5) * span[1] / ny,
        indexing="ij")
    cand = np.stack([X.ravel(), Y.ravel()], axis=1)
    cand = cand + rng.uniform(-0.15, 0.15, cand.shape) * lc_min
    lc_c = np.asarray(lc_fn(cand))
    ok = inside_fn(cand)
    cand, lc_c = cand[ok], lc_c[ok]
    order = np.argsort(lc_c)
    cand, lc_c = cand[order], lc_c[order]

    # hierarchical hash grids for rejection: a single lc_min grid makes a
    # coarse-region query scan (2*lc/lc_min + 1)^2 mostly-EMPTY cells —
    # profiled 231 of 236 s (498M dict gets) building the DFG mesh at
    # cyl_factor 0.25, quadratically worse as lc_min shrinks.  With one
    # grid per octave (cell = lc_min * 2^k) a query uses the level where
    # radius <= cell and scans at most 9 cells; accepted points are
    # inserted into every level (~log2(lc_max/lc_min) lists).  The
    # accept/reject decision is set-membership, so output is identical.
    cell = lc_min
    accepted = []
    r_max = k_exclusion * float(lc_c.max()) if len(lc_c) else cell
    K = max(0, int(np.ceil(np.log2(max(r_max / cell, 1.0)))))
    cells_k = [cell * (1 << k) for k in range(K + 1)]
    grids = [dict() for _ in range(K + 1)]

    def neighbors(p, radius):
        k = min(K, max(0, int(np.ceil(np.log2(max(radius / cell, 1.0))))))
        ck = cells_k[k]
        g = grids[k]
        ci = int((p[0] - lo[0]) / ck)
        cj = int((p[1] - lo[1]) / ck)
        r = int(np.ceil(radius / ck))          # <= 1 by choice of k
        for di in range(-r, r + 1):
            for dj in range(-r, r + 1):
                for q in g.get((ci + di, cj + dj), ()):
                    yield q

    def insert(p):
        for k in range(K + 1):
            ck = cells_k[k]
            grids[k].setdefault(
                (int((p[0] - lo[0]) / ck), int((p[1] - lo[1]) / ck)),
                []).append(p)

    for b in boundary:
        insert(b)
    for p, lc in zip(cand, lc_c):
        r = k_exclusion * lc
        r2 = r * r
        clash = False
        for q in neighbors(p, r):
            d = p - q
            if d[0] * d[0] + d[1] * d[1] < r2:
                clash = True
                break
        if not clash:
            accepted.append(p)
            insert(p)
    if not accepted:
        return np.zeros((0, 2))
    return np.array(accepted)


def boundary_layer_rings(
    center: np.ndarray,
    radius: float,
    lc_surface: float,
    n_layers: int = 4,
    first: float = 0.3,
    ratio: float = 1.45,
) -> np.ndarray:
    """Concentric point rings for a circular obstacle's boundary layer.

    Radial offsets grow geometrically from ``first * lc_surface``; the
    tangential spacing on each ring tracks the local radial spacing (mild
    anisotropy that plain Delaunay still meshes well).  Native analogue of
    gmsh's BoundaryLayer field for the DFG cylinders (reference
    dfg_pillar_2D.geo refines isotropically; resolving the cylinder
    boundary layer is what the lift coefficient actually needs).
    """
    pts = []
    d = first * lc_surface
    off = 0.0
    for _ in range(n_layers):
        off += d
        spacing = max(0.8 * lc_surface, 0.9 * d)
        n = max(16, int(np.ceil(2 * np.pi * (radius + off) / spacing)))
        th = np.linspace(0, 2 * np.pi, n, endpoint=False)
        pts.append(np.stack([
            center[0] + (radius + off) * np.cos(th),
            center[1] + (radius + off) * np.sin(th)], axis=1))
        d *= ratio
    return np.concatenate(pts, axis=0)


def structured_annulus(
    center: np.ndarray,
    radius: float,
    lc_surface: float,
    n_layers: int = 4,
    first: float = 0.35,
    ratio: float = 1.4,
):
    """Reflection-symmetric structured triangle annulus around a circle.

    The DFG lift coefficient is 0.2% of drag: on quasi-random Delaunay
    meshes the mesh-asymmetry error near the cylinder swamps it (measured
    oscillation -44%..+220% across scales).  This band makes the
    discretization in the sensitive region EXACTLY mirror-symmetric about
    the horizontal axis through the center, so the spurious (mesh-
    induced) lift cancels by symmetry: offset-half angles
    theta_k = (k+1/2)*2pi/n (a set closed under theta -> -theta) and a
    union-jack split (every quad -> 4 triangles through its centroid,
    symmetric under any reflection).  Ring radii grow geometrically from
    ``first * lc_surface``; all rings share the node count n.

    Returns (points, triangles, inner_ids, outer_ids): inner_ids lie
    exactly ON the circle (surface nodes), outer_ids form the outer ring
    polygon (in angular order) for gluing into an unstructured far field
    via ``triangulate_sizefield(fixed_hole_loops=...)`` +
    ``merge_meshes``.
    """
    n = 2 * max(8, int(np.ceil(np.pi * radius / (0.9 * lc_surface))))
    th = (np.arange(n) + 0.5) * (2 * np.pi / n)
    radii = [radius]
    d = first * lc_surface
    for _ in range(n_layers):
        radii.append(radii[-1] + d)
        d *= ratio
    m = len(radii) - 1
    ring_pts = [np.stack([center[0] + r * np.cos(th),
                          center[1] + r * np.sin(th)], axis=1)
                for r in radii]
    pts = list(ring_pts)
    tris = []
    cent_base = n * (m + 1)
    for i in range(m):
        a = i * n + np.arange(n)                  # ring i
        b = i * n + (np.arange(n) + 1) % n
        c = (i + 1) * n + (np.arange(n) + 1) % n  # ring i+1
        dd = (i + 1) * n + np.arange(n)
        quad_cent = (ring_pts[i] + ring_pts[i][(np.arange(n) + 1) % n]
                     + ring_pts[i + 1]
                     + ring_pts[i + 1][(np.arange(n) + 1) % n]) / 4
        pts.append(quad_cent)
        e = cent_base + i * n + np.arange(n)
        tris.append(np.stack([a, b, e], axis=1))
        tris.append(np.stack([b, c, e], axis=1))
        tris.append(np.stack([c, dd, e], axis=1))
        tris.append(np.stack([dd, a, e], axis=1))
    points = np.concatenate(pts, axis=0)
    triangles = np.concatenate(tris, axis=0).astype(np.int32)
    inner_ids = np.arange(n)
    outer_ids = m * n + np.arange(n)
    return points, triangles, inner_ids, outer_ids


def merge_meshes(a: SimplexMesh, b: SimplexMesh) -> SimplexMesh:
    """Glue two triangulations sharing bit-identical interface nodes.

    The structured-annulus path guarantees exactness: the annulus outer
    ring is passed verbatim into ``triangulate_sizefield`` via
    fixed_hole_loops (never resampled; Lloyd smoothing pins fixed nodes
    with np.where, tri2d.py _lloyd_smooth), so the shared coordinates are
    the same float64 bits in both meshes and dedup by exact match is
    safe (no tolerance cliff)."""
    assert a.cell == b.cell
    pts = np.ascontiguousarray(
        np.concatenate([a.points, b.points], axis=0))
    view = pts.view([("", pts.dtype)] * pts.shape[1]).ravel()
    _, first, inv = np.unique(view, return_index=True, return_inverse=True)
    cells = np.concatenate(
        [inv[a.cells], inv[b.cells + a.n_nodes]], axis=0)
    return SimplexMesh(a.cell, pts[first], cells.astype(np.int32))


def triangulate_sizefield(
    outer_loop: np.ndarray,
    hole_loops: Sequence[np.ndarray],
    lc_fn: Callable,
    lc_min: float,
    smooth_iters: int = 2,
    extra_points: np.ndarray = None,
    fixed_hole_loops: Sequence[np.ndarray] = (),
) -> SimplexMesh:
    """Mesh the region inside outer_loop minus the holes, graded by lc_fn.

    extra_points: fixed interior points inserted verbatim (e.g. boundary-
    layer rings); dart throwing keeps its exclusion distance from them.
    fixed_hole_loops: hole boundaries used VERBATIM (no resampling, nodes
    never smoothed) — e.g. the outer ring of a structured annulus whose
    nodes must survive for merge_meshes gluing."""
    loops = [resample_loop_field(outer_loop, lc_fn)]
    for h in hole_loops:
        loops.append(resample_loop_field(h, lc_fn))
    for h in fixed_hole_loops:
        loops.append(np.asarray(h, float))
    hole_loops = list(hole_loops) + list(fixed_hole_loops)
    bpts = np.concatenate(loops, axis=0)

    def inside(pts):
        m = points_in_polygon(pts, outer_loop)
        for h in hole_loops:
            m &= ~points_in_polygon(pts, h)
        return m

    lo = outer_loop.min(axis=0)
    hi = outer_loop.max(axis=0)
    n_fixed = len(bpts)
    excl = bpts
    if extra_points is not None and len(extra_points):
        keep_x = inside(extra_points)
        extra_points = extra_points[keep_x]
        excl = np.concatenate([bpts, extra_points], axis=0)
    interior = dart_points(lo, hi, lc_fn, lc_min, excl, inside)
    if extra_points is not None and len(extra_points):
        interior = np.concatenate([extra_points, interior], axis=0)
        n_fixed += len(extra_points)
    pts, simplices, loop_ids = _delaunay_conforming(loops, interior)
    fixed = np.zeros(len(pts), dtype=bool)
    fixed[:n_fixed] = True
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
    keep = inside(cent)
    msh = SimplexMesh("triangle", pts, simplices[keep]).orient_positive()
    used = np.unique(msh.cells.ravel())
    remap = -np.ones(msh.n_nodes, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return SimplexMesh("triangle", msh.points[used],
                       remap[msh.cells].astype(np.int32))
