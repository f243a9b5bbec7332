"""Structured simplex meshers (gmsh-free paths).

The reference keeps two gmsh-free cases: the lid-driven cavity built with
``dolfinx.mesh.create_unit_square(..., CellType.triangle)``
(reference LidDrivenFlow/LidDrivenNavierStokesFlow.py:29-30) and the square
duct whose geometry DuctStokesFlow constructs itself
(reference StokesFlow/DuctStokesFlow.py:39-142).  These meshers reproduce
those meshes natively so the smoke tests never touch an external mesher.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .core import SimplexMesh, mark_boundary_facets


def unit_interval(n: int) -> SimplexMesh:
    pts = np.linspace(0.0, 1.0, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return SimplexMesh("interval", pts, cells)


def unit_square_tri(nx: int, ny: int, diagonal: str = "right") -> SimplexMesh:
    """[0,1]^2 triangulated like dolfinx create_unit_square (default diagonal)."""
    return rect_tri(nx, ny, (0.0, 0.0), (1.0, 1.0), diagonal)


def rect_tri(
    nx: int,
    ny: int,
    lo: Tuple[float, float],
    hi: Tuple[float, float],
    diagonal: str = "right",
) -> SimplexMesh:
    x = np.linspace(lo[0], hi[0], nx + 1)
    y = np.linspace(lo[1], hi[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i, j = I.ravel(), J.ravel()
    v00, v10 = vid(i, j), vid(i + 1, j)
    v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
    if diagonal == "right":
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
    else:  # "left"
        t1 = np.stack([v00, v10, v01], axis=1)
        t2 = np.stack([v10, v11, v01], axis=1)
    cells = np.concatenate([t1, t2], axis=0)
    return SimplexMesh("triangle", pts, cells).orient_positive()


# Kuhn split of the unit cube into 6 tets sharing the (0,0,0)-(1,1,1) diagonal.
_KUHN = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 5, 7],
        [0, 2, 3, 7],
        [0, 2, 6, 7],
        [0, 4, 5, 7],
        [0, 4, 6, 7],
    ],
    dtype=np.int64,
)


def box_tet(
    n: Tuple[int, int, int],
    lo: Tuple[float, float, float],
    hi: Tuple[float, float, float],
) -> SimplexMesh:
    """Axis-aligned box meshed with 6 tets per cube (Kuhn subdivision).

    The Kuhn split is conforming across cube faces, so the mesh is valid for
    any (nx, ny, nz).
    """
    nx, ny, nz = n
    xs = np.linspace(lo[0], hi[0], nx + 1)
    ys = np.linspace(lo[1], hi[1], ny + 1)
    zs = np.linspace(lo[2], hi[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    i, j, k = I.ravel(), J.ravel(), K.ravel()
    # cube corner ids in (dx, dy, dz) binary order: bit2=x, bit1=y, bit0=z
    corners = np.stack(
        [
            vid(i, j, k),
            vid(i, j, k + 1),
            vid(i, j + 1, k),
            vid(i, j + 1, k + 1),
            vid(i + 1, j, k),
            vid(i + 1, j, k + 1),
            vid(i + 1, j + 1, k),
            vid(i + 1, j + 1, k + 1),
        ],
        axis=1,
    )  # (ncubes, 8) with index bits (x<<2 | y<<1 | z)
    cells = corners[:, _KUHN].reshape(-1, 4)
    return SimplexMesh("tetrahedron", pts, cells).orient_positive()


def duct_mesh(n_cross: int, n_axial: int, length: float = 4.0) -> SimplexMesh:
    """Square duct x in [0, length], (y, z) in [-0.5, 0.5]^2 with markers.

    Markers follow the reference channel convention
    (reference NavierStokes/image2gmsh3D.py:435-440):
      1 = inlet (x=0), 3 = outlet (x=length), 4 = walls.
    """
    msh = box_tet(
        (n_axial, n_cross, n_cross),
        (0.0, -0.5, -0.5),
        (length, 0.5, 0.5),
    )
    eps = 1e-10
    mark_boundary_facets(
        msh,
        {
            1: lambda p: p[:, 0] < eps,
            3: lambda p: p[:, 0] > length - eps,
        },
        default=4,
    )
    # box_tet numbers nodes x-major: node = l * n2d + i2d, so the duct is
    # directly usable by the layered operator (assemble/layered.py)
    n2d = (n_cross + 1) * (n_cross + 1)
    msh.layered = (n2d, n_axial + 1, np.ones(msh.n_nodes, bool))
    return msh
