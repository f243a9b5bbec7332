"""The discrete problem of one channel case, worked out again from the
served mesh: its boundary, the Dirichlet conditions, the inlet profiles
and the residual of the stabilized Navier-Stokes equations.

The problem (reference NavierStokesChannelFlow.py:127-147, 220-266):
P1-P1 velocity and pressure on tetrahedra, the SUPS/LSIC form with the
G-metric tau (C_I = 36) and the upstream's transposed advection in the
stabilisation (UFL ``dot(u, grad(.))``), a 4-point degree-2 rule.
No-slip on every wall, the inlet profiles on the two inlet regions at
x = 0 (they win over the wall on the shared rim), p = 0 at the outlet.
The residual's Dirichlet rows are w - g, as SNES sees them.

The inlet profiles (image2inlet.py:240-353): on each of the two 2D
inlet meshes, -lap u = const with u = 0 on the boundary, normalised to
mean 1, scaled to carry ``ratio`` and ``1 - ratio`` of unit flow, and
evaluated at the 3D inlet nodes (0 outside the 2D mesh, barycentric
tolerance 1e-6).  The 2D meshes are the program's; the solve is done
again here.
"""

from __future__ import annotations

import numpy as np
import torch

# 4-point degree-2 rule on the reference tetrahedron (weights sum to 1/6)
_A, _B = 0.1381966011250105, 0.5854101966249685
QP = np.array([[_A, _A, _A], [_B, _A, _A], [_A, _B, _A], [_A, _A, _B]])
QW = np.full(4, 1.0 / 24.0)
# P1 basis gradients on the reference cell (constant)
DPHI = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                 [0.0, 0.0, 1.0]])
PHI = np.stack([1.0 - QP.sum(1), QP[:, 0], QP[:, 1], QP[:, 2]], axis=1)


def boundary_facets(cells: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(nf, 3) node triples of the faces that belong to one cell only."""
    if n_nodes >= 2 ** 21:
        raise ValueError("too many nodes for the 63-bit face key")
    faces = cells[:, [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]]]
    faces = faces.reshape(-1, 3).sort(dim=1).values
    key = (faces[:, 0] * n_nodes + faces[:, 1]) * n_nodes + faces[:, 2]
    uniq, counts = torch.unique(key, return_counts=True)
    k = uniq[counts == 1]
    return torch.stack([k // (n_nodes * n_nodes), (k // n_nodes) % n_nodes,
                        k % n_nodes], dim=1)


def poisson_profile(points2d: np.ndarray, tris: np.ndarray, share: float
                    ) -> np.ndarray:
    """Nodal P1 solution of -lap u = 1, u = 0 on the boundary, scaled to
    carry ``share`` of unit flow (the forcing cancels in the scaling)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import spsolve

    p = points2d[tris]                                  # (nt, 3, 2)
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    area = 0.5 * np.abs(det)
    # gradients of the three hat functions
    gy = np.stack([e1[:, 1] - e2[:, 1], e2[:, 1], -e1[:, 1]], 1) / det[:, None]
    gz = np.stack([e2[:, 0] - e1[:, 0], -e2[:, 0], e1[:, 0]], 1) / det[:, None]
    K = (gy[:, :, None] * gy[:, None, :] + gz[:, :, None] * gz[:, None, :]) \
        * area[:, None, None]
    n = len(points2d)
    A = coo_matrix((K.ravel(), (np.repeat(tris, 3, 1).ravel(),
                                np.tile(tris, (1, 3)).ravel())),
                   shape=(n, n)).tocsr()
    b = np.bincount(tris.ravel(), np.repeat(area / 3.0, 3), minlength=n)
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                    tris[:, [0, 2]]]), axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    free = np.ones(n, dtype=bool)
    free[uniq[counts == 1].ravel()] = False
    u = np.zeros(n)
    u[free] = spsolve(A[free][:, free].tocsc(), b[free])
    integral = float((area * u[tris].mean(axis=1)).sum())
    return u * (share / integral)


def eval_p1_2d(points2d: np.ndarray, tris: np.ndarray, u: np.ndarray,
               q: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """The P1 field at the (m, 2) points q; 0 where no triangle holds a
    point to the barycentric tolerance."""
    p = points2d[tris]
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    out = np.zeros(len(q))
    for s in range(0, len(q), 512):
        d = q[s:s + 512, None, :] - p[None, :, 0, :]    # (m, nt, 2)
        l1 = (d[..., 0] * e2[:, 1] - d[..., 1] * e2[:, 0]) / det
        l2 = (e1[:, 0] * d[..., 1] - e1[:, 1] * d[..., 0]) / det
        lam = np.stack([1.0 - l1 - l2, l1, l2], -1)     # (m, nt, 3)
        inside = (lam >= -tol).all(-1)
        hit = inside.any(1)
        t = inside.argmax(1)
        rows = np.arange(len(t))
        val = (lam[rows, t] * u[tris[t]]).sum(1)
        out[s:s + 512] = np.where(hit, val, 0.0)
    return out


def dirichlet(points: np.ndarray, cells: torch.Tensor, x_outlet: float,
              ratio: float, inlet1, inlet2):
    """(dofs, values) of the Dirichlet conditions, node-blocked dofs
    (u_x, u_y, u_z, p) per node.  inlet1/inlet2 are (points2d, tris) of
    the inner and outer 2D inlet meshes."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(points)
    g = np.zeros((n, 4))
    fixed = np.zeros((n, 4), dtype=bool)
    used = np.zeros(n, dtype=bool)
    used[cells.cpu().numpy().ravel()] = True
    fixed[~used] = True                     # nodes of no cell: zero
    facets = boundary_facets(cells, n).cpu().numpy()
    fx = points[facets, 0]
    at_inlet = (np.abs(fx) < 1e-9).all(1)
    at_outlet = (np.abs(fx - x_outlet) < 1e-9).all(1)
    wall = np.unique(facets[~at_inlet & ~at_outlet])
    fixed[wall, :3] = True
    inl = facets[at_inlet]
    nodes = np.unique(inl)
    # the inlet's two regions are the components of its facets' graph
    idx = np.searchsorted(nodes, inl)
    e = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]], idx[:, [0, 2]]])
    graph = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                       shape=(len(nodes), len(nodes)))
    ncomp, label = connected_components(graph, directed=False)
    if ncomp != 2:
        raise ValueError(f"the inlet has {ncomp} regions, not 2")
    centre = inlet1[0].mean(axis=0)
    near = np.argmin(((points[nodes, 1:3] - centre) ** 2).sum(1))
    for k, (mesh2d, share) in enumerate(((inlet1, ratio),
                                         (inlet2, 1.0 - ratio))):
        inner = label == label[near]
        sel = nodes[inner if k == 0 else ~inner]
        prof = poisson_profile(mesh2d[0], mesh2d[1], share)
        g[sel, :3] = 0.0
        g[sel, 0] = eval_p1_2d(mesh2d[0], mesh2d[1], prof, points[sel, 1:3])
        fixed[sel, :3] = True
    out = np.unique(facets[at_outlet])
    fixed[out, 3] = True
    g[out, 3] = 0.0
    return fixed.ravel(), g.ravel()


def sups_residual(points: torch.Tensor, cells: torch.Tensor,
                  w: torch.Tensor, nu: float, C_I: float = 36.0,
                  block: int = 1 << 17) -> torch.Tensor:
    """Assembled residual (n, 4) of the SUPS/LSIC form at the nodal
    state w (n, 4) = (u_x, u_y, u_z, p); no Dirichlet rows applied."""
    dt, dev = w.dtype, w.device
    phi = torch.as_tensor(PHI, dtype=dt, device=dev)        # (q, a)
    dphi = torch.as_tensor(DPHI, dtype=dt, device=dev)      # (a, k)
    wq = torch.as_tensor(QW, dtype=dt, device=dev)
    F = torch.zeros_like(w)
    es = torch.einsum
    for s in range(0, cells.shape[0], block):
        c = cells[s:s + block]
        X = points[c].to(dt)                                # (B, 4, 3)
        J = (X[:, 1:] - X[:, :1]).transpose(1, 2)           # dx_i/dxi_k
        invJ = torch.linalg.inv(J)                          # dxi_k/dx_i
        detJ = torch.linalg.det(J).abs()
        g = es("ak,bki->bai", dphi, invJ)                   # (B, a, i)
        G = es("bki,bkj->bij", invJ, invJ)
        trG = G.diagonal(dim1=1, dim2=2).sum(-1)
        GdG = (G * G).sum((1, 2))
        W = w[c]                                            # (B, a, 4)
        un, pn = W[..., :3], W[..., 3]
        uq = es("qa,bai->bqi", phi, un)
        gu = es("bai,baj->bij", un, g)                      # du_i/dx_j
        gp = es("ba,bai->bi", pn, g)
        div = gu.diagonal(dim1=1, dim2=2).sum(-1)
        pq = es("qa,ba->bq", phi, pn)
        uGu = es("bqi,bij,bqj->bq", uq, G, uq)
        tau = 1.0 / torch.sqrt(uGu + C_I * nu * nu * GdG[:, None])
        nul = 1.0 / (trG[:, None] * tau)
        adv = es("bij,bqj->bqi", gu, uq)                    # (u.grad) u
        res = es("bij,bqi->bqj", gu, uq) + gp[:, None, :]   # (grad u)^T u
        rdg = es("bqj,baj->bqa", res, g)
        ru = (es("q,bqi,qa->bai", wq, adv, phi)
              + nu * wq.sum() * es("bij,baj->bai", gu, g)
              - es("q,bq,bai->bai", wq, pq, g)
              + es("q,bq,bqi,bqa->bai", wq, tau, uq, rdg)
              + es("q,bq,b,bai->bai", wq, nul, div, g))
        rp = (es("q,b,qa->ba", wq, div, phi)
              + es("q,bq,bqa->ba", wq, tau, rdg))
        r = torch.cat([ru, rp[..., None]], -1) * detJ[:, None, None]
        F.index_add_(0, c.reshape(-1), r.reshape(-1, 4))
    return F


def residual_norm(points: np.ndarray, cells: np.ndarray, u: np.ndarray,
                  p: np.ndarray, Re: float, ratio: float, x_outlet: float,
                  inlet1, inlet2, device, dtype=torch.float64) -> float:
    """||F(w)||_2 with the Dirichlet rows w - g: the served fields
    against the discrete problem."""
    cells_t = torch.as_tensor(cells, dtype=torch.int64, device=device)
    fixed, g = dirichlet(points, cells_t, x_outlet, ratio, inlet1, inlet2)
    w = torch.as_tensor(np.concatenate([u, p[:, None]], 1), dtype=dtype,
                        device=device)
    F = sups_residual(torch.as_tensor(points, dtype=dtype, device=device),
                      cells_t, w, 1.0 / Re).reshape(-1)
    fixed_t = torch.as_tensor(fixed, device=device)
    F = torch.where(fixed_t, w.reshape(-1)
                    - torch.as_tensor(g, dtype=dtype, device=device), F)
    return float(torch.linalg.vector_norm(F))
