"""Lagrange element tables and quadrature rules on simplices.

Host-side replacement for Basix tabulation (SURVEY.md section 2.2): the
reference calls ``basix.ufl.element("Lagrange", cell, degree)`` everywhere
(e.g. reference NavierStokes/NavierStokesChannelFlow.py:120-121).  Here the
shape functions are closed-form and tabulated once into small numpy arrays
that become constants inside the element kernels — no runtime
tabulation, no C++.

Reference cells (FEniCSx conventions):
  interval: vertices 0:(0) 1:(1)
  triangle: vertices 0:(0,0) 1:(1,0) 2:(0,1)
  tetrahedron: vertices 0:(0,0,0) 1:(1,0,0) 2:(0,1,0) 3:(0,0,1)

P2 extra dofs sit at edge midpoints; edge ordering follows the FEniCSx
convention (edges sorted by (min,max) vertex tuple):
  triangle edges: (1,2), (0,2), (0,1)
  tet edges:      (2,3), (1,3), (1,2), (0,3), (0,2), (0,1)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np

# ----------------------------------------------------------------------------
# Quadrature
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuadratureRule:
    """Points in reference coordinates, weights summing to reference volume."""

    points: np.ndarray   # (nq, dim)
    weights: np.ndarray  # (nq,)

    @property
    def nq(self) -> int:
        return self.points.shape[0]


def _interval_gauss(n: int) -> QuadratureRule:
    x, w = np.polynomial.legendre.leggauss(n)
    return QuadratureRule(((x + 1.0) / 2.0)[:, None], w / 2.0)


def _triangle_rule(degree: int) -> QuadratureRule:
    if degree <= 1:
        pts = np.array([[1 / 3, 1 / 3]])
        wts = np.array([0.5])
    elif degree == 2:
        # classic 3-point rule (matches basix default accuracy for degree 2)
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        wts = np.array([1 / 6, 1 / 6, 1 / 6])
    elif degree == 3:
        pts = np.array(
            [[1 / 3, 1 / 3], [0.6, 0.2], [0.2, 0.6], [0.2, 0.2]])
        wts = np.array([-27 / 96, 25 / 96, 25 / 96, 25 / 96])
    elif degree <= 5:
        a1, b1 = 0.059715871789770, 0.470142064105115
        a2, b2 = 0.797426985353087, 0.101286507323456
        w1, w2 = 0.066197076394253, 0.062969590272414
        pts = np.array(
            [
                [1 / 3, 1 / 3],
                [a1, b1], [b1, a1], [b1, b1],
                [a2, b2], [b2, a2], [b2, b2],
            ]
        )
        wts = np.array([0.1125, w1, w1, w1, w2, w2, w2])
    else:
        # tensor-product Gauss collapsed (Duffy); robust for any degree
        n = (degree + 2) // 2 + 1
        gx, gw = np.polynomial.legendre.leggauss(n)
        gx = (gx + 1) / 2
        gw = gw / 2
        X, Y = np.meshgrid(gx, gx, indexing="ij")
        WX, WY = np.meshgrid(gw, gw, indexing="ij")
        x = X * (1 - Y)
        y = Y
        w = WX * WY * (1 - Y)
        pts = np.stack([x.ravel(), y.ravel()], axis=1)
        wts = w.ravel()
    return QuadratureRule(pts, wts)


def _tet_rule(degree: int) -> QuadratureRule:
    if degree <= 1:
        pts = np.array([[0.25, 0.25, 0.25]])
        wts = np.array([1 / 6])
    elif degree == 2:
        # symmetric 4-point rule
        a = 0.5854101966249685
        b = 0.1381966011250105
        pts = np.array(
            [[b, b, b], [a, b, b], [b, a, b], [b, b, a]])
        wts = np.full(4, 1 / 24)
    elif degree == 3:
        pts = np.array(
            [
                [0.25, 0.25, 0.25],
                [1 / 2, 1 / 6, 1 / 6],
                [1 / 6, 1 / 2, 1 / 6],
                [1 / 6, 1 / 6, 1 / 2],
                [1 / 6, 1 / 6, 1 / 6],
            ]
        )
        wts = np.array([-4 / 30, 9 / 120, 9 / 120, 9 / 120, 9 / 120])
    elif degree <= 5:
        # Keast 14-point degree-5 rule
        a1 = 0.0673422422100983
        b1 = 0.3108859192633005
        a2 = 0.7217942490673264
        b2 = 0.0927352503108912
        a3 = 0.4544962958743506
        b3 = 0.0455037041256494
        w1 = 0.1126879257180162 / 6
        w2 = 0.0734930431163619 / 6
        w3 = 0.0425460207770812 / 6
        pts = []
        wts = []
        for (a, b, w) in [(a1, b1, w1), (a2, b2, w2)]:
            pts += [[b, b, b], [a, b, b], [b, a, b], [b, b, a]]
            wts += [w] * 4
        pts += [
            [a3, a3, b3], [a3, b3, a3], [b3, a3, a3],
            [b3, b3, a3], [b3, a3, b3], [a3, b3, b3],
        ]
        wts += [w3] * 6
        pts = np.array(pts)
        wts = np.array(wts)
    else:
        # collapsed Gauss (Duffy) — exact to arbitrary degree
        n = (degree + 2) // 2 + 1
        gx, gw = np.polynomial.legendre.leggauss(n)
        gx = (gx + 1) / 2
        gw = gw / 2
        X, Y, Z = np.meshgrid(gx, gx, gx, indexing="ij")
        WX, WY, WZ = np.meshgrid(gw, gw, gw, indexing="ij")
        x = X * (1 - Y) * (1 - Z)
        y = Y * (1 - Z)
        z = Z
        w = WX * WY * WZ * (1 - Y) * (1 - Z) ** 2 * (1 - Z)
        # jacobian of the Duffy map: (1-y)(1-z)^2? careful:
        # x = u(1-v)(1-w), y = v(1-w), z = w  => J = (1-v)(1-w)^2
        w = WX * WY * WZ * (1 - Y) * (1 - Z) ** 2
        pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
        wts = w.ravel()
    return QuadratureRule(pts, wts)


def quadrature(cell: str, degree: int) -> QuadratureRule:
    """Quadrature rule exact for polynomials of the given degree."""
    if cell == "interval":
        return _interval_gauss(max(1, (degree + 2) // 2))
    if cell == "triangle":
        return _triangle_rule(degree)
    if cell == "tetrahedron":
        return _tet_rule(degree)
    raise ValueError(f"unknown cell {cell!r}")


# ----------------------------------------------------------------------------
# Elements
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Element:
    """A scalar Lagrange element: tabulated values/gradients at points."""

    cell: str
    degree: int
    ndof: int
    dim: int
    # dof coordinates in reference cell, (ndof, dim)
    dof_points: np.ndarray
    _phi: Callable[[np.ndarray], np.ndarray] = dataclasses.field(repr=False)
    _dphi: Callable[[np.ndarray], np.ndarray] = dataclasses.field(repr=False)

    def tabulate(self, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Return (values (npts, ndof), grads (npts, ndof, dim))."""
        pts = np.asarray(points, dtype=np.float64)
        return self._phi(pts), self._dphi(pts)


# ---- P1 ----

def _p1_interval_phi(p):
    x = p[:, 0]
    return np.stack([1 - x, x], axis=1)


def _p1_interval_dphi(p):
    n = p.shape[0]
    g = np.array([[-1.0], [1.0]])
    return np.broadcast_to(g, (n, 2, 1)).copy()


def _p1_tri_phi(p):
    x, y = p[:, 0], p[:, 1]
    return np.stack([1 - x - y, x, y], axis=1)


def _p1_tri_dphi(p):
    n = p.shape[0]
    g = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    return np.broadcast_to(g, (n, 3, 2)).copy()


def _p1_tet_phi(p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return np.stack([1 - x - y - z, x, y, z], axis=1)


def _p1_tet_dphi(p):
    n = p.shape[0]
    g = np.array(
        [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )
    return np.broadcast_to(g, (n, 4, 3)).copy()


# ---- P2 (vertices then edge midpoints, FEniCSx edge order) ----

TRI_EDGES = np.array([(1, 2), (0, 2), (0, 1)])
TET_EDGES = np.array([(2, 3), (1, 3), (1, 2), (0, 3), (0, 2), (0, 1)])
TET_FACES = np.array([(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)])


def _p2_from_bary(lams, dlams):
    """Build P2 values/grads from barycentric coords and their gradients.

    lams: (npts, nvert); dlams: (nvert, dim); edges: rows of vertex pairs.
    """

    def build(edges):
        def phi(p):
            lam = lams(p)                       # (n, nv)
            vert = lam * (2 * lam - 1)          # (n, nv)
            edge = 4 * lam[:, edges[:, 0]] * lam[:, edges[:, 1]]
            return np.concatenate([vert, edge], axis=1)

        def dphi(p):
            lam = lams(p)
            dl = dlams()                        # (nv, dim)
            n = lam.shape[0]
            vert = (4 * lam - 1)[:, :, None] * dl[None, :, :]
            e0, e1 = edges[:, 0], edges[:, 1]
            edge = 4 * (
                lam[:, e0, None] * dl[None, e1, :]
                + lam[:, e1, None] * dl[None, e0, :]
            )
            return np.concatenate([vert, edge], axis=1)

        return phi, dphi

    return build


def p1_interval() -> Element:
    return Element("interval", 1, 2, 1,
                   np.array([[0.0], [1.0]]), _p1_interval_phi, _p1_interval_dphi)


def p1_triangle() -> Element:
    return Element("triangle", 1, 3, 2,
                   np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
                   _p1_tri_phi, _p1_tri_dphi)


def p1_tet() -> Element:
    return Element(
        "tetrahedron", 1, 4, 3,
        np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float),
        _p1_tet_phi, _p1_tet_dphi)


def p2_triangle() -> Element:
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    lams = lambda p: np.stack([1 - p[:, 0] - p[:, 1], p[:, 0], p[:, 1]], axis=1)
    dlams = lambda: np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    phi, dphi = _p2_from_bary(lams, dlams)(TRI_EDGES)
    mids = 0.5 * (verts[TRI_EDGES[:, 0]] + verts[TRI_EDGES[:, 1]])
    return Element("triangle", 2, 6, 2, np.vstack([verts, mids]), phi, dphi)


def p2_tet() -> Element:
    verts = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    lams = lambda p: np.stack(
        [1 - p[:, 0] - p[:, 1] - p[:, 2], p[:, 0], p[:, 1], p[:, 2]], axis=1)
    dlams = lambda: np.array(
        [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    phi, dphi = _p2_from_bary(lams, dlams)(TET_EDGES)
    mids = 0.5 * (verts[TET_EDGES[:, 0]] + verts[TET_EDGES[:, 1]])
    return Element("tetrahedron", 2, 10, 3, np.vstack([verts, mids]), phi, dphi)


def element(cell: str, degree: int) -> Element:
    table = {
        ("interval", 1): p1_interval,
        ("triangle", 1): p1_triangle,
        ("triangle", 2): p2_triangle,
        ("tetrahedron", 1): p1_tet,
        ("tetrahedron", 2): p2_tet,
    }
    try:
        return table[(cell, degree)]()
    except KeyError:
        raise ValueError(f"unsupported element ({cell}, P{degree})") from None
