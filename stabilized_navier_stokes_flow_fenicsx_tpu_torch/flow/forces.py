"""Aerodynamic force coefficients from boundary integrals.

Counterpart of the JAX package's ``flow/forces.py`` (the boundary
integrals are host numpy; ``reaction_force`` reads the raw residual from
the assembler's device and sums on the host; ``reaction_from_residual``
sums on the residual's device and reads three numbers).  Replicates the
reference's drag/lift evaluations:

* 2D tangential-gradient formulation (DFG_2D_Validation.py:197-214):
    u_t = (n_y, -n_x) . u,  n = -FacetNormal (pointing out of the obstacle)
    C_D =  2/(rho U^2 L) * sum_e (nu grad(u_t).n n_y - p n_x) |e|
    C_L = -2/(rho U^2 L) * sum_e (nu grad(u_t).n n_x + p n_y) |e|

* 3D traction-integral formulation (DFG_3D_Validation.py:344-367):
    F = sum_f sigma(u, p) . n |f|,  C = 2 F / (rho U^2 L)

P1 fields: cell gradients are constant, facet pressure is the nodal mean.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..mesh.core import SimplexMesh, facets_of_cells
from ..utils.profiling import read, traced


def facet_owners(mesh: SimplexMesh, facets: np.ndarray) -> np.ndarray:
    """Owner cell of each (boundary) facet given as sorted vertex rows."""
    fv, owners = facets_of_cells(mesh.cell, mesh.cells)
    nv = mesh.n_nodes
    if facets.shape[1] == 2:
        keys = fv[:, 0].astype(np.int64) * nv + fv[:, 1]
        q = (np.minimum(facets[:, 0], facets[:, 1]).astype(np.int64) * nv
             + np.maximum(facets[:, 0], facets[:, 1]))
    else:
        fs = np.sort(facets, axis=1).astype(np.int64)
        keys = (fv[:, 0].astype(np.int64) * nv + fv[:, 1]) * nv + fv[:, 2]
        q = (fs[:, 0] * nv + fs[:, 1]) * nv + fs[:, 2]
    order = np.argsort(keys)
    pos = np.searchsorted(keys[order], q)
    assert (keys[order][pos] == q).all(), "facet not found in mesh"
    return owners[order][pos]


def _cell_gradients_2d(mesh: SimplexMesh, cells_sel: np.ndarray,
                       nodal: np.ndarray) -> np.ndarray:
    """Constant P1 gradient of a scalar field on the selected cells."""
    c = mesh.cells[cells_sel]
    p = mesh.points[c][:, :, :2]
    e = p[:, 1:, :] - p[:, :1, :]
    det = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
    # gradients of barycentric functions
    g1 = np.stack([e[:, 1, 1], -e[:, 1, 0]], axis=1) / det[:, None]
    g2 = np.stack([-e[:, 0, 1], e[:, 0, 0]], axis=1) / det[:, None]
    g0 = -g1 - g2
    vals = nodal[c]                            # (m, 3)
    return (vals[:, 0:1] * g0 + vals[:, 1:2] * g1 + vals[:, 2:3] * g2)


def dfg_2d_coefficients(
    mesh: SimplexMesh,
    u: np.ndarray,              # (n, 2)
    p: np.ndarray,              # (n,)
    obstacle_marker: int = 5,
    nu: float = 1e-3,
    rho_U2_L: float = 0.1 * 0.2**2,
) -> Tuple[float, float]:
    """(C_D, C_L) with the reference's tangential-gradient formula."""
    facets = mesh.facets[mesh.facet_markers == obstacle_marker]
    owners = facet_owners(mesh, facets)
    a = mesh.points[facets[:, 0]][:, :2]
    b = mesh.points[facets[:, 1]][:, :2]
    t = b - a
    length = np.hypot(t[:, 0], t[:, 1])
    # domain-outward normal: opposite the cell centroid
    nrm = np.stack([t[:, 1], -t[:, 0]], axis=1) / length[:, None]
    cent = mesh.points[mesh.cells[owners]][:, :, :2].mean(axis=1)
    mid = 0.5 * (a + b)
    flip = np.einsum("ei,ei->e", nrm, cent - mid) > 0
    nrm[flip] *= -1.0
    n = -nrm                                   # reference: n = -FacetNormal

    # u_t nodal values per facet (n constant per facet)
    u_t_a = n[:, 1] * u[facets[:, 0], 0] - n[:, 0] * u[facets[:, 0], 1]
    u_t_b = n[:, 1] * u[facets[:, 1], 0] - n[:, 0] * u[facets[:, 1], 1]
    # grad(u_t) . n from the owner-cell P1 gradients
    gux = _cell_gradients_2d(mesh, owners, u[:, 0])
    guy = _cell_gradients_2d(mesh, owners, u[:, 1])
    grad_ut = n[:, 1:2] * gux - n[:, 0:1] * guy
    dudn = np.einsum("ei,ei->e", grad_ut, n)
    p_bar = 0.5 * (p[facets[:, 0]] + p[facets[:, 1]])

    cd = (2.0 / rho_U2_L) * np.sum(
        (nu * dudn * n[:, 1] - p_bar * n[:, 0]) * length)
    cl = (-2.0 / rho_U2_L) * np.sum(
        (nu * dudn * n[:, 0] + p_bar * n[:, 1]) * length)
    return float(cd), float(cl)


@traced("traction")
def traction_force_3d(
    mesh: SimplexMesh,
    u: np.ndarray,              # (n, 3)
    p: np.ndarray,
    obstacle_marker: int,
    nu: float,
    owners: Optional[np.ndarray] = None,
) -> np.ndarray:
    """F = integral of sigma.n over the marked surface (DFG 3D style);
    ``owners``: ``facet_owners`` of the marked facets, when the caller
    keeps them (they take a sort of every cell's facets)."""
    facets = mesh.facets[mesh.facet_markers == obstacle_marker]
    if owners is None:
        owners = facet_owners(mesh, facets)
    tp = mesh.points[facets]
    av = np.cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]) / 2.0
    area = np.linalg.norm(av, axis=1)
    nrm = av / area[:, None]
    cent = mesh.points[mesh.cells[owners]].mean(axis=1)
    mid = tp.mean(axis=1)
    flip = np.einsum("ei,ei->e", nrm, cent - mid) > 0
    nrm[flip] *= -1.0

    # owner-cell gradient of each velocity component
    c = mesh.cells[owners]
    pc = mesh.points[c]
    e = pc[:, 1:, :] - pc[:, :1, :]
    invT = np.linalg.inv(np.transpose(e, (0, 2, 1)))
    gref = np.array([[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]])
    grads = np.einsum("ak,eik->eai", gref, invT)     # (m, 4, 3)
    gu = np.einsum("eai,eaj->eji", grads, u[c])      # du_j/dx_i -> (m,j,i)
    sym = 0.5 * (gu + np.transpose(gu, (0, 2, 1)))
    p_bar = p[facets].mean(axis=1)
    sigma = 2.0 * nu * sym - p_bar[:, None, None] * np.eye(3)[None]
    tr = np.einsum("eij,ej->ei", sigma, nrm)
    return (tr * area[:, None]).sum(axis=0)


def reaction_force(
    asm,                        # assemble.assembly.Assembler
    kernel,                     # the (nonlinear) residual element kernel
    space,                      # MixedVelocityPressureSpace
    mesh: SimplexMesh,
    w: np.ndarray,
    obstacle_marker: int,
) -> np.ndarray:
    """Consistent (variational) force on a Dirichlet boundary.

    At the discrete solution the raw weak residual vanishes on free dofs;
    on constrained dofs it equals the negative discrete reaction — testing
    the momentum equation with a function that is e_i on the obstacle
    nodes and zero elsewhere yields the consistent boundary traction
    integral including all stabilization terms.  This is the
    superconvergent way to evaluate DFG forces (measured: Cd error drops
    from ~7% to ~1.5% on the same meshes vs the surface-integral formula
    the reference uses, DFG_2D_Validation.py:197-203, which is kept for
    parity in dfg_2d_coefficients)."""
    r = asm.residual(kernel, asm.vector(w)).cpu().numpy()
    obst = mesh.nodes_with_marker(obstacle_marker)
    dim = space.dim
    return np.array([
        -r[np.asarray(space.velocity_dof(obst, c))].sum()
        for c in range(dim)])


def reaction_from_residual(r, dofs) -> np.ndarray:
    """``reaction_force`` from a raw residual already assembled: minus
    the sum of ``r`` over the obstacle's velocity dofs ``dofs`` (dim, n),
    on ``r``'s device, with one read of the ``dim`` numbers."""
    import torch

    return read(-r[dofs].sum(1), torch.Tensor.cpu).double().numpy()
