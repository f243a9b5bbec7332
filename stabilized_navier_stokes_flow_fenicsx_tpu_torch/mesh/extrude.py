"""Extruded 3D channel mesher (native replacement for image2gmsh3D).

The reference builds the channel with gmsh OCC: a 1x1 x [0,4] box whose
inlet face carries the two image contours, extruded as interior splitter
walls to x_extrude = 0.5 (reference NavierStokes/image2gmsh3D.py:164-488,
hard-coded extents :192-194).  Redesign: the conforming 2D
cross-section triangulation (mesh/tri2d.py) is extruded through graded
x-layers into prisms, prisms split into tetrahedra with Dompierre's
minimum-vertex-index rule (conforming for any neighbor pair), and the
splitter-band prisms with x < x_extrude are simply omitted — leaving the
solid splitter tube as a void whose surfaces become no-slip walls.

Facet markers match the reference physical groups (image2gmsh3D.py:435-440):
  1 = inlet_1 (x=0 inside the inner contour)
  2 = inlet_2 (x=0 outside the outer contour)
  3 = outlet  (x=x_outlet)
  4 = wall    (box sides, splitter lateral surfaces, splitter end cap)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import ChannelGeometry
from .core import SimplexMesh, boundary_facets
from .tri2d import TriMesh2D, points_in_polygon

# Dompierre et al., "How to Subdivide Pyramids, Prisms and Hexahedra into
# Tetrahedra": rotations bringing each vertex to slot 0 while preserving
# orientation (prism vertices: bottom 0,1,2; top 3,4,5 with i+3 above i).
_PRISM_ROT = np.array(
    [
        [0, 1, 2, 3, 4, 5],
        [1, 2, 0, 4, 5, 3],
        [2, 0, 1, 5, 3, 4],
        [3, 5, 4, 0, 2, 1],
        [4, 3, 5, 1, 0, 2],
        [5, 4, 3, 2, 1, 0],
    ],
    dtype=np.int64,
)
# tet pattern A: diagonal V1-V5 on the far quad; B: diagonal V2-V4
_TETS_A = np.array([[0, 1, 2, 5], [0, 1, 5, 4], [0, 4, 5, 3]])
_TETS_B = np.array([[0, 1, 2, 4], [0, 4, 2, 5], [0, 4, 5, 3]])


def split_prisms(prisms: np.ndarray) -> np.ndarray:
    """(n, 6) global prism connectivity -> (3n, 4) conforming tets."""
    n = prisms.shape[0]
    imin = np.argmin(prisms, axis=1)
    rot = _PRISM_ROT[imin]                          # (n, 6)
    V = np.take_along_axis(prisms, rot, axis=1)     # rotated, V0 = min
    useA = np.minimum(V[:, 1], V[:, 5]) < np.minimum(V[:, 2], V[:, 4])
    tets = np.where(useA[:, None, None], V[:, _TETS_A], V[:, _TETS_B])
    return tets.reshape(3 * n, 4)


def grade_layers(geom: ChannelGeometry, lc: float) -> np.ndarray:
    """x-plane positions with the reference's refinement-box intent
    (image2gmsh3D.py:445-483): ~0.75*lc cells around the splitter region,
    coarsening to ~2*lc toward the outlet; a plane lands exactly on
    x_extrude so the splitter ends on a mesh plane."""

    def dx_of(x):
        if x < geom.x_extrude + 0.25:
            return geom.lc_inlet_factor * lc
        if x < geom.x_extrude + 0.75:
            return geom.lc_mid_factor * lc * 1.5
        return geom.lc_outlet_factor * lc

    # segment [0, x_extrude]: uniform fine layers
    n1 = max(1, int(round(geom.x_extrude / (geom.lc_inlet_factor * lc))))
    planes = list(np.linspace(0.0, geom.x_extrude, n1 + 1))
    x = geom.x_extrude
    while x < geom.x_outlet - 1e-12:
        step = min(dx_of(x), geom.x_outlet - x)
        # avoid a sliver last layer
        if geom.x_outlet - (x + step) < 0.4 * step:
            step = geom.x_outlet - x
        x += step
        planes.append(x)
    return np.array(planes)


def extrude_tri_mesh(
    tri_mesh: SimplexMesh,
    z_planes: np.ndarray,
) -> SimplexMesh:
    """Generic prism extrusion of a 2D triangle mesh along z.

    2D points (x, y) become (x, y, z); the gmsh ``Extrude{...; Layers{n}}``
    equivalent used by the DFG 3D pillar mesh (reference
    Validation_Flow/dfg_pillar_3D.geo:96).
    """
    pts2 = tri_mesh.points[:, :2]
    tris = tri_mesh.cells.astype(np.int64)
    np2 = pts2.shape[0]
    nl = len(z_planes) - 1
    Z = np.repeat(z_planes, np2)
    XY = np.tile(pts2, (len(z_planes), 1))
    points = np.column_stack([XY, Z])
    prisms = []
    for l in range(nl):
        bot = tris + l * np2
        top = tris + (l + 1) * np2
        prisms.append(np.concatenate([bot, top], axis=1))
    tets = split_prisms(np.concatenate(prisms, axis=0))
    mesh = SimplexMesh("tetrahedron", points, tets.astype(np.int32))
    return mesh.orient_positive()


def extrude_channel(
    tri: TriMesh2D,
    inner_contour: np.ndarray,
    geom: ChannelGeometry = ChannelGeometry(),
    lc: Optional[float] = None,
    x_planes: Optional[np.ndarray] = None,
    compact: bool = True,
) -> SimplexMesh:
    """Extrude the cross-section triangulation into the marked channel mesh.

    inner_contour: (m, 2) loop in (y, z) used to classify inlet facets.

    compact=False keeps the full plane-major node grid (node = l*n2d + i,
    including nodes interior to the solid splitter, which no cell touches)
    and attaches ``mesh.layered = (n2d, n_planes, used_mask)`` — the
    layout assemble/layered.py requires.
    """
    if x_planes is None:
        assert lc is not None
        x_planes = grade_layers(geom, lc)
    pts2 = tri.mesh.points                     # (np2, 2) = (y, z)
    tris = tri.mesh.cells.astype(np.int32)     # (nt, 3)
    np2 = pts2.shape[0]
    nl = len(x_planes) - 1

    # nodes: plane-major
    X = np.repeat(x_planes, np2)
    YZ = np.tile(pts2, (len(x_planes), 1))
    points = np.column_stack([X, YZ])

    # prisms per layer, dropping solid splitter-band prisms (region 1)
    tol = 1e-9
    all_prisms = []
    keep_grid = np.ones((nl, tris.shape[0]), dtype=bool)
    for l in range(nl):
        keep = np.ones(tris.shape[0], dtype=bool)
        if x_planes[l + 1] <= geom.x_extrude + tol:
            keep = tri.regions != 1
        keep_grid[l] = keep
        bot = tris[keep] + np.int32(l * np2)
        top = tris[keep] + np.int32((l + 1) * np2)
        all_prisms.append(np.concatenate([bot, top], axis=1))
    prisms = np.concatenate(all_prisms, axis=0)

    from ..utils.native import split_prisms_oriented_native

    tets = split_prisms_oriented_native(points, prisms)
    oriented = tets is not None
    if not oriented:
        tets = split_prisms(prisms.astype(np.int64))

    # linear used-node mark (np.unique sorts 4*nc ids: ~0.7 s at 1.45M
    # cells on the single-core bench host)
    used_mask = np.zeros(points.shape[0], dtype=bool)
    used_mask[tets.ravel()] = True
    if compact:
        # drop unused nodes (interior of the solid splitter)
        used = np.nonzero(used_mask)[0]
        remap = -np.ones(points.shape[0], dtype=np.int64)
        remap[used] = np.arange(len(used))
        mesh = SimplexMesh(
            "tetrahedron", points[used], remap[tets].astype(np.int32))
    else:
        mesh = SimplexMesh("tetrahedron", points,
                           np.asarray(tets, np.int32))
        mesh.layered = (np2, len(x_planes), used_mask)
        # (layer, column) cell grid for the structured assembly
        # (assemble/structured.py): cells were emitted layer-major,
        # kept-tri-major, tet-minor — exactly this grid's order
        mesh.extrusion = (tris.shape[0], nl, keep_grid)
    if not oriented:
        mesh.orient_positive()

    # facet markers from the actual boundary
    bf = boundary_facets(mesh)
    mids = mesh.points[bf].mean(axis=1)
    eps = 1e-9
    tags = np.full(bf.shape[0], 4, dtype=np.int32)   # default: wall
    at_inlet = mids[:, 0] < eps
    at_outlet = mids[:, 0] > geom.x_outlet - eps
    tags[at_outlet] = 3
    if at_inlet.any():
        in_inner = points_in_polygon(mids[at_inlet][:, 1:3], inner_contour)
        tags[np.nonzero(at_inlet)[0][in_inner]] = 1
        tags[np.nonzero(at_inlet)[0][~in_inner]] = 2
    mesh.facets = bf
    mesh.facet_markers = tags
    return mesh
