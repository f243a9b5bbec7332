"""Inlet velocity profiles from the image (fully-developed flow).

Replicates reference NavierStokes/image2inlet.py:240-353: per contour
region, solve the Poisson problem -lap u = 10 with u = 0 on all boundary
facets (the axial momentum equation of fully-developed laminar flow),
normalize each profile to mean 1, then scale by flowrate_ratio/area_1 and
(1 - flowrate_ratio)/area_2.

The 2D meshes are native triangulations (mesh/tri2d.py) instead of gmsh
models; the solves are a host sparse LU (the reference uses MUMPS LU,
image2inlet.py:272 — the same discrete solution).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import Config, DEFAULT
from ..fem.interpolate import GridLocator, build_locator, interpolate_p1_np
from ..mesh.core import SimplexMesh, boundary_facets
from ..mesh.image import get_contours, load_image, optimize_contour
from ..mesh.tri2d import triangulate_polygon, triangulate_square_minus


@dataclasses.dataclass
class InletProfile:
    """A 2D fully-developed velocity profile, evaluable anywhere."""

    mesh: SimplexMesh
    u: np.ndarray                 # nodal axial velocity
    area: float
    average: float                # mean before normalization
    _locator: Optional[GridLocator] = None

    def eval(self, yz: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Evaluate at (n, 2) points; outside the mesh -> fill (dolfinx
        non-matching interpolation semantics, padding=1e-6)."""
        if self._locator is None:
            self._locator = build_locator(self.mesh)
        return interpolate_p1_np(
            self.mesh, self.u, yz, self._locator, fill=fill, tol=1e-6)


def _p1_integral(mesh: SimplexMesh, u: np.ndarray) -> float:
    """Exact integral of a P1 field: sum_T |T| * mean(nodal values)."""
    vols = mesh.cell_volumes()
    return float((vols * u[mesh.cells].mean(axis=1)).sum())


def solve_poisson_profile(mesh: SimplexMesh, forcing: float = 10.0,
                          ) -> Tuple[np.ndarray, float, float]:
    """-lap u = forcing, u = 0 on the whole boundary. Returns
    (nodal u, area, mean velocity) — reference image2inlet.py:240-291.

    These systems are tiny (O(1k) dofs) preprocessing — the reference
    solves them with MUMPS LU (image2inlet.py:272).  A host-side sparse LU
    (exact, like the reference) is all they need; the device path stays
    the job of the 3D solves.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import spsolve

    pts = mesh.points[:, :2]
    cells = mesh.cells
    n = mesh.n_nodes
    # P1 stiffness via the cotangent/gradient formula
    p = pts[cells]                                # (nc, 3, 2)
    e = p[:, 1:, :] - p[:, :1, :]                 # (nc, 2, 2) rows=edges
    det = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
    area2 = np.abs(det)
    inv = np.empty_like(e)                        # inverse of [e0; e1]^T
    inv[:, 0, 0] = e[:, 1, 1] / det
    inv[:, 0, 1] = -e[:, 0, 1] / det
    inv[:, 1, 0] = -e[:, 1, 0] / det
    inv[:, 1, 1] = e[:, 0, 0] / det
    gref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    # invJ = (e^{-1})^T since J = e^T (columns are edge vectors)
    grads = np.einsum("ak,nik->nai", gref, inv)   # (nc, 3, 2)
    Ke = np.einsum("nai,nbi,n->nab", grads, grads, area2 / 2.0)
    rows = np.repeat(cells, 3, axis=1).ravel()
    cols = np.tile(cells, (1, 3)).ravel()
    A = coo_matrix((Ke.ravel(), (rows, cols)), shape=(n, n)).tocsr()
    b = np.zeros(n)
    np.add.at(b, cells.ravel(),
              np.repeat(forcing * area2 / 6.0, 3))
    bnodes = np.unique(boundary_facets(mesh).ravel())
    free = np.ones(n, dtype=bool)
    free[bnodes] = False
    u = np.zeros(n)
    u[free] = spsolve(A[free][:, free].tocsc(), b[free])
    area = float(mesh.cell_volumes().sum())
    avg = _p1_integral(mesh, u) / area
    return u, area, avg


def solve_inlet_profiles(
    img_fname: str,
    flowrate_ratio: float,
    cfg: Config = DEFAULT,
) -> Tuple[InletProfile, InletProfile]:
    """Image -> (inner profile, outer profile), scaled so the inner region
    carries ``flowrate_ratio`` of unit total flow (image2inlet.py:294-353).
    """
    gray = load_image(img_fname)
    contours = get_contours(gray, cfg.contour)
    if len(contours) != 2:
        raise ValueError(
            f"expected 2 contours in {img_fname}, found {len(contours)}")
    outer_c, lc_o = optimize_contour(
        contours[0], cfg.contour.fft_cutoff_inlet, cfg.contour.rdp_epsilon,
        cfg.contour.mesh_lc_frac_inlet)
    inner_c, lc_i = optimize_contour(
        contours[1], cfg.contour.fft_cutoff_inlet, cfg.contour.rdp_epsilon,
        cfg.contour.mesh_lc_frac_inlet)

    # mesh coordinates: (y, z) = (col-normalized, flipped-row-normalized)
    inner_loop = inner_c[:, [1, 0]]
    outer_loop = outer_c[:, [1, 0]]
    mesh_inner = triangulate_polygon(inner_loop, lc_i)
    mesh_outer = triangulate_square_minus(outer_loop, lc_o,
                                          cfg.channel.half_width)

    u1, area1, avg1 = solve_poisson_profile(
        mesh_inner, cfg.inlet_poisson_forcing)
    u2, area2, avg2 = solve_poisson_profile(
        mesh_outer, cfg.inlet_poisson_forcing)

    # normalize to mean 1, then scale to the flowrate split
    u1 = u1 / avg1 * (flowrate_ratio / area1)
    u2 = u2 / avg2 * ((1.0 - flowrate_ratio) / area2)
    return (
        InletProfile(mesh_inner, u1, area1, avg1),
        InletProfile(mesh_outer, u2, area2, avg2),
    )
