"""Function spaces and dofmaps as flat int32 arrays.

Host-side replacement for the DOLFINx dofmap machinery (SURVEY.md 2.2):
``functionspace``, mixed elements, and ``collapse`` (reference
NavierStokes/NavierStokesChannelFlow.py:119-147) become precomputed numpy
index arrays that are uploaded to the device once.

Two layouts:

* ``FunctionSpace`` — scalar or blocked-vector Lagrange space.  Vector dofs
  interleave per node: dof = scalar_dof * vs + component (same as dolfinx
  blocked elements).
* ``MixedVelocityPressureSpace`` — the mixed (velocity, pressure) space.
  For equal-order P1-P1 the layout is node-blocked: every mesh node carries
  ``dim`` velocity components plus one pressure, dof = node*(dim+1)+comp.
  This makes the Jacobian a block-CSR matrix with (dim+1)^2 node blocks —
  the format used by assemble/ and solve/.
  For Taylor-Hood P2-P1 velocity dofs come first (node-interleaved), then
  pressure vertex dofs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import numpy as np

from ..mesh.core import SimplexMesh
from .elements import Element, element, TRI_EDGES, TET_EDGES


def _unique_edges(cells: np.ndarray, edges_local: np.ndarray):
    """Global edge numbering: returns (edges (ne,2) sorted, cell_edges (nc, nle))."""
    ev = cells[:, edges_local.reshape(-1)].reshape(-1, 2)
    ev = np.sort(ev, axis=1)
    uniq, inv = np.unique(ev, axis=0, return_inverse=True)
    cell_edges = inv.reshape(cells.shape[0], edges_local.shape[0])
    return uniq.astype(np.int32), cell_edges.astype(np.int32)


@dataclasses.dataclass
class FunctionSpace:
    """Lagrange space of given degree and value size over a mesh."""

    mesh: SimplexMesh
    elem: Element
    vs: int                     # value size (1 scalar, dim for velocity)
    n_scalar_dofs: int
    cell_dofs_scalar: np.ndarray   # (n_cells, ndof_local) scalar dof ids
    dof_coords: np.ndarray         # (n_scalar_dofs, gdim)
    edge_nodes: Optional[np.ndarray] = None  # (n_edges, 2) for P2

    @property
    def ndofs(self) -> int:
        return self.n_scalar_dofs * self.vs

    @property
    def ndof_local(self) -> int:
        return self.elem.ndof * self.vs

    def cell_dofs(self) -> np.ndarray:
        """(n_cells, ndof_local) blocked dof ids, node-major interleaved."""
        if self.vs == 1:
            return self.cell_dofs_scalar
        base = self.cell_dofs_scalar[:, :, None] * self.vs
        comp = np.arange(self.vs, dtype=np.int32)[None, None, :]
        return (base + comp).reshape(self.mesh.n_cells, -1)

    def scalar_dofs_on_nodes(self, nodes: np.ndarray) -> np.ndarray:
        """Scalar dofs supported on the given mesh vertices (P1: identity;
        P2: vertices plus edges whose both endpoints are in ``nodes``)."""
        nodes = np.asarray(nodes)
        if self.elem.degree == 1:
            return nodes.astype(np.int32)
        mask = np.zeros(self.mesh.n_nodes, dtype=bool)
        mask[nodes] = True
        both = mask[self.edge_nodes].all(axis=1)
        edge_dofs = self.mesh.n_nodes + np.nonzero(both)[0]
        return np.concatenate([nodes, edge_dofs]).astype(np.int32)

    def dofs_on_facets(self, facets: np.ndarray, component: Optional[int] = None
                       ) -> np.ndarray:
        """Blocked dof ids supported on the given facets (rows of vertex ids)."""
        sdofs = self.scalar_dofs_on_nodes(np.unique(facets.ravel()))
        if self.vs == 1:
            return sdofs
        if component is not None:
            return sdofs * self.vs + component
        return (sdofs[:, None] * self.vs
                + np.arange(self.vs, dtype=np.int32)[None, :]).ravel()


def make_space(mesh: SimplexMesh, degree: int, vs: int = 1) -> FunctionSpace:
    elem = element(mesh.cell, degree)
    if degree == 1:
        cd = mesh.cells
        coords = mesh.points
        return FunctionSpace(mesh, elem, vs, mesh.n_nodes, cd, coords)
    edges_local = TRI_EDGES if mesh.cell == "triangle" else TET_EDGES
    edge_nodes, cell_edges = _unique_edges(mesh.cells, edges_local)
    n_sdofs = mesh.n_nodes + edge_nodes.shape[0]
    cd = np.concatenate(
        [mesh.cells, mesh.n_nodes + cell_edges], axis=1).astype(np.int32)
    mid = 0.5 * (mesh.points[edge_nodes[:, 0]] + mesh.points[edge_nodes[:, 1]])
    coords = np.vstack([mesh.points, mid])
    return FunctionSpace(mesh, elem, vs, n_sdofs, cd, coords, edge_nodes)


@dataclasses.dataclass
class MixedVelocityPressureSpace:
    """Mixed (u, p) space. Equal-order -> node-blocked; TH -> stacked."""

    mesh: SimplexMesh
    V: FunctionSpace            # velocity (vs = dim)
    Q: FunctionSpace            # pressure (vs = 1)
    equal_order: bool
    cell_dofs_w: np.ndarray     # (n_cells, ndl_w) mixed dof ids
    ndofs: int

    @property
    def dim(self) -> int:
        return self.mesh.gdim

    @property
    def block_size(self) -> int:
        """Node block size for equal-order layout (dim velocity + 1 pressure)."""
        return self.dim + 1 if self.equal_order else 1

    @property
    def ndl(self) -> int:
        return self.cell_dofs_w.shape[1]

    # ---- dof addressing -------------------------------------------------
    def velocity_dof(self, scalar_dof, comp):
        if self.equal_order:
            return scalar_dof * (self.dim + 1) + comp
        return scalar_dof * self.dim + comp

    def pressure_dof(self, scalar_dof):
        if self.equal_order:
            return scalar_dof * (self.dim + 1) + self.dim
        return self.V.ndofs + scalar_dof

    def velocity_dofs_on_facets(self, facets: np.ndarray) -> np.ndarray:
        sdofs = self.V.scalar_dofs_on_nodes(np.unique(facets.ravel()))
        comps = np.arange(self.dim, dtype=np.int32)
        return self.velocity_dof(sdofs[:, None], comps[None, :]).ravel()

    def pressure_dofs_on_facets(self, facets: np.ndarray) -> np.ndarray:
        sdofs = self.Q.scalar_dofs_on_nodes(np.unique(facets.ravel()))
        return self.pressure_dof(sdofs)

    # ---- split / combine -------------------------------------------------
    def split(self, w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """w -> (u (n_scalar_v, dim), p (n_scalar_q,)). Works on numpy or torch."""
        if self.equal_order:
            wb = w.reshape(-1, self.dim + 1)
            return wb[:, : self.dim], wb[:, self.dim]
        u = w[: self.V.ndofs].reshape(-1, self.dim)
        p = w[self.V.ndofs:]
        return u, p

    def combine(self, u: np.ndarray, p: np.ndarray) -> np.ndarray:
        if isinstance(u, torch.Tensor):
            if self.equal_order:
                return torch.cat([u, p[:, None]], dim=1).reshape(-1)
            return torch.cat([u.reshape(-1), p])
        if self.equal_order:
            wb = np.concatenate([u, p[:, None]], axis=1)
            return wb.reshape(-1)
        return np.concatenate([u.reshape(-1), p])


def make_mixed_space(mesh: SimplexMesh, v_degree: int = 1, p_degree: int = 1
                     ) -> MixedVelocityPressureSpace:
    """Build the mixed space. P1-P1 equal order or P2-P1 Taylor-Hood."""
    dim = mesh.gdim
    V = make_space(mesh, v_degree, vs=dim)
    Q = make_space(mesh, p_degree, vs=1)
    equal_order = v_degree == p_degree
    nc = mesh.n_cells
    if equal_order:
        bs = dim + 1
        # local ordering: node-major [u_x, u_y, (u_z), p] per node
        base = V.cell_dofs_scalar[:, :, None] * bs
        comp = np.arange(bs, dtype=np.int32)[None, None, :]
        cdw = (base + comp).reshape(nc, -1)
        ndofs = V.n_scalar_dofs * bs
    else:
        # velocity dofs first (node-interleaved), then pressure dofs
        vbase = V.cell_dofs_scalar[:, :, None] * dim
        comp = np.arange(dim, dtype=np.int32)[None, None, :]
        vd = (vbase + comp).reshape(nc, -1)
        pd = V.ndofs + Q.cell_dofs_scalar
        cdw = np.concatenate([vd, pd], axis=1).astype(np.int32)
        ndofs = V.ndofs + Q.ndofs
    return MixedVelocityPressureSpace(mesh, V, Q, equal_order,
                                      cdw.astype(np.int32), ndofs)
