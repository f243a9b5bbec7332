"""Host simplex mesh.

Replacement for the DOLFINx C++ mesh core (SURVEY.md section 2.2):
topology and geometry live as flat int32/float arrays ready to be uploaded
to the device, rather than behind a C++ topology object.  Facet markers replace the
gmsh physical-group -> dolfinx meshtags pipeline
(reference NavierStokes/NavierStokesChannelFlow.py:111-116).

Marker conventions follow the reference channel mesh
(reference NavierStokes/image2gmsh3D.py:435-440):
  1 = inlet_1 (inner contour), 2 = inlet_2 (outer), 3 = outlet, 4 = wall.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# local facet -> vertex maps (FEniCSx convention: facet i is opposite vertex i)
TRI_FACETS = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)
TET_FACETS = np.array(
    [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int32)

_CELL_FACETS = {"triangle": TRI_FACETS, "tetrahedron": TET_FACETS}
_CELL_DIM = {"interval": 1, "triangle": 2, "tetrahedron": 3}
_CELL_NVERT = {"interval": 2, "triangle": 3, "tetrahedron": 4}


@dataclasses.dataclass
class SimplexMesh:
    """An unstructured simplex mesh as flat arrays.

    points : (n_nodes, gdim) float64 vertex coordinates
    cells  : (n_cells, nvert) int32 vertex indices
    facets : (n_marked_facets, nvert-1) int32 — marked boundary/interior facets
    facet_markers : (n_marked_facets,) int32 tags
    """

    cell: str
    points: np.ndarray
    cells: np.ndarray
    facets: Optional[np.ndarray] = None
    facet_markers: Optional[np.ndarray] = None

    def __post_init__(self):
        self.points = np.ascontiguousarray(self.points, dtype=np.float64)
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)
        if self.facets is not None:
            self.facets = np.ascontiguousarray(self.facets, dtype=np.int32)
            self.facet_markers = np.ascontiguousarray(
                self.facet_markers, dtype=np.int32)

    @property
    def dim(self) -> int:
        return _CELL_DIM[self.cell]

    @property
    def gdim(self) -> int:
        return self.points.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.points.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    def facets_with_marker(self, marker: int) -> np.ndarray:
        """All marked facets with the given tag, (m, nvert-1) vertex indices."""
        if self.facets is None:
            raise ValueError("mesh has no facet markers")
        return self.facets[self.facet_markers == marker]

    def nodes_with_marker(self, marker: int) -> np.ndarray:
        """Unique vertex indices lying on facets with the given tag."""
        return np.unique(self.facets_with_marker(marker).ravel())

    def cell_volumes(self) -> np.ndarray:
        """Signed -> absolute simplex volumes (numpy, host-side)."""
        p = self.points[self.cells]  # (nc, nv, d)
        e = p[:, 1:, :] - p[:, :1, :]
        if self.dim == 1:
            return np.abs(e[:, 0, 0])
        if self.dim == 2:
            det = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
            return np.abs(det) / 2.0
        det = np.linalg.det(e)
        return np.abs(det) / 6.0

    def orient_positive(self) -> "SimplexMesh":
        """Flip cells with negative Jacobian determinant (in place)."""
        p = self.points[self.cells]
        e = p[:, 1:, :] - p[:, :1, :]
        if self.dim == 2:
            det = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
        elif self.dim == 3:
            # explicit triple product: np.linalg.det dispatches LAPACK
            # per batch entry — ~20x slower at 10^6 cells (profiled)
            a, b, c = e[:, 0], e[:, 1], e[:, 2]
            det = (a[:, 0] * (b[:, 1] * c[:, 2] - b[:, 2] * c[:, 1])
                   - a[:, 1] * (b[:, 0] * c[:, 2] - b[:, 2] * c[:, 0])
                   + a[:, 2] * (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0]))
        else:
            det = e[:, 0, 0]
        neg = det < 0
        if np.any(neg):
            c = self.cells.copy()
            c[neg, -2], c[neg, -1] = self.cells[neg, -1], self.cells[neg, -2]
            self.cells = c
        return self


def facets_of_cells(cell: str, cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All (cell, local_facet) facets as sorted vertex tuples.

    Returns (facet_vertices (n_cells*nf, fv), owner_cell (n_cells*nf,)).
    """
    lf = _CELL_FACETS[cell]
    nf, fv = lf.shape
    fverts = cells[:, lf.reshape(-1)].reshape(-1, fv)  # (nc*nf, fv)
    fverts_sorted = np.sort(fverts, axis=1)
    owners = np.repeat(np.arange(cells.shape[0], dtype=np.int32), nf)
    return fverts_sorted, owners


def boundary_facets(mesh: SimplexMesh) -> np.ndarray:
    """Facets appearing in exactly one cell, (n_bf, fv) sorted vertex ids."""
    from ..utils.native import boundary_facets_native

    nat = boundary_facets_native(mesh.cells)
    if nat is not None:
        return nat
    fverts, _ = facets_of_cells(mesh.cell, mesh.cells)
    uniq, counts = np.unique(fverts, axis=0, return_counts=True)
    return uniq[counts == 1].astype(np.int32)


def mark_boundary_facets(
    mesh: SimplexMesh,
    marker_fns: Dict[int, "callable"],
    default: Optional[int] = None,
) -> None:
    """Attach facet markers by geometric predicates on facet midpoints.

    marker_fns maps tag -> fn(points (m, gdim)) -> bool mask; first match
    wins in ascending tag order.  Facets matching nothing get ``default``
    (or stay unmarked if None).
    """
    bf = boundary_facets(mesh)
    mids = mesh.points[bf].mean(axis=1)
    tags = np.full(bf.shape[0], -1, dtype=np.int32)
    for tag in sorted(marker_fns):
        mask = np.asarray(marker_fns[tag](mids), dtype=bool)
        tags[(tags == -1) & mask] = tag
    if default is not None:
        tags[tags == -1] = default
    keep = tags != -1
    extra_f = mesh.facets if mesh.facets is not None else np.zeros(
        (0, bf.shape[1]), np.int32)
    extra_m = mesh.facet_markers if mesh.facet_markers is not None else np.zeros(
        (0,), np.int32)
    mesh.facets = np.vstack([extra_f, bf[keep]]).astype(np.int32)
    mesh.facet_markers = np.concatenate([extra_m, tags[keep]]).astype(np.int32)
