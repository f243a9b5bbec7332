"""DFG 3D-1Z's discrete problem worked out again from the served mesh:
its boundary, the Dirichlet conditions, the residual of the stabilized
Navier-Stokes equations and the consistent reaction force on the pillar.

The problem (Schaefer and Turek 1996, test case 3D-1Z; upstream
NavierStokes/Validation_Flow/DFG_3D_Validation.py): the channel
[0, 2.2] x [0, 0.41] x [0, 0.41] around a pillar of radius 0.05 at
(0.5, 0.2) through the whole span; P1-P1 velocity and pressure on
tetrahedra; the SUPS/LSIC form with the G-metric tau (C_I = 36) in its
textbook form, the strong residual (u . grad) u + grad p tested with
tau (u . grad) v + tau grad q (not the channel's transposed advection:
that form is inconsistent and spoils the reaction force), a 4-point
degree-2 rule.  Boundary, told from the coordinates alone: a boundary
face with every node at x = 0 is the inlet, at x = 2.2 the outlet (do
nothing, no pressure condition), any other is no-slip; no-slip wins at a
node shared with the inlet (the inflow is zero there too).  The inflow
is bi-parabolic, u_x = 16 Um y z (H - y)(H - z) / H^4 with Um = 0.45.

The pillar is the boundary faces whose centroid lies within ``band`` of
the circle r = 0.05 about (0.5, 0.2), measured in the cross-section:
``band`` is the configuration's (the program tags the pillar so, and
takes in the end walls' first ring of faces around it); the force is
minus the raw residual's velocity rows summed over the nodes of those
faces, C = 2 F / (Uc^2 Lc) with Uc = 0.2 and Lc = 0.041.

Plain ``torch`` in float64, in blocks of cells, on any device; float32
matrix products would run without TF32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .channel import DPHI, PHI, QW, boundary_facets

L, H = 2.2, 0.41
CX, CY, R = 0.5, 0.2, 0.05
UM = 0.45
UC, LC = 0.2, 0.041


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products in float32, not TF32, inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def inflow(y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """The bi-parabolic inflow u_x at (y, z)."""
    return (4 * y * (H - y) / H**2) * (4 * z * (H - z) / H**2) * UM


class Problem:
    """The boundary of one served mesh: ``fixed`` (n, 4) Dirichlet flags,
    ``g`` (n, 4) their values, ``pillar`` the nodes of the pillar's
    faces; tensors on ``device``."""

    def __init__(self, points: np.ndarray, cells: np.ndarray, band: float,
                 device):
        self.device = torch.device(device)
        self.points = torch.as_tensor(points, dtype=torch.float64,
                                      device=self.device)
        self.cells = torch.as_tensor(cells, dtype=torch.int64,
                                     device=self.device)
        n = len(points)
        facets = boundary_facets(self.cells, n).cpu().numpy()
        mid = points[facets].mean(axis=1)
        at_inlet = (np.abs(points[facets, 0]) < 1e-9).all(1)
        at_outlet = (np.abs(points[facets, 0] - L) < 1e-9).all(1)
        noslip = np.unique(facets[~at_inlet & ~at_outlet])
        inlet = np.unique(facets[at_inlet])
        on_pillar = (~at_inlet & ~at_outlet
                     & (np.hypot(mid[:, 0] - CX, mid[:, 1] - CY) < R + band))
        self.pillar = np.unique(facets[on_pillar])
        fixed = np.zeros((n, 4), dtype=bool)
        g = np.zeros((n, 4))
        fixed[inlet, :3] = True
        g[inlet, 0] = inflow(points[inlet, 1], points[inlet, 2])
        fixed[noslip, :3] = True
        g[noslip, :3] = 0.0
        self.fixed = torch.as_tensor(fixed, device=self.device)
        self.g = torch.as_tensor(g, dtype=torch.float64, device=self.device)

    def state(self, u: np.ndarray, p: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.concatenate([u, p[:, None]], 1),
                               dtype=torch.float64, device=self.device)

    def evaluate(self, u: np.ndarray, p: np.ndarray, nu: float) -> dict:
        """``residual``: ||F(w)||_2 with the Dirichlet rows w - g;
        ``cd``, ``cl``: the reaction force's coefficients."""
        w = self.state(u, p)
        with no_tf32():
            F = sups_residual(self.points, self.cells, w, nu)
        res = torch.where(self.fixed, w - self.g, F)
        force = -F[torch.as_tensor(self.pillar, device=self.device), :3].sum(0)
        cd, cl = (2.0 * force[:2] / (UC**2 * LC)).tolist()
        return {"residual": float(torch.linalg.vector_norm(res)),
                "cd": cd, "cl": cl}


def sups_residual(points: torch.Tensor, cells: torch.Tensor,
                  w: torch.Tensor, nu: float, C_I: float = 36.0,
                  block: int = 1 << 17) -> torch.Tensor:
    """Assembled residual (n, 4) of the textbook SUPS/LSIC form at the
    nodal state w (n, 4) = (u_x, u_y, u_z, p); no Dirichlet rows."""
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
        res = adv + gp[:, None, :]                          # strong residual
        udg = es("bqj,baj->bqa", uq, g)                     # u . grad(phi_a)
        rdg = es("bqj,baj->bqa", res, g)                    # res . grad(phi_a)
        ru = (es("q,bqi,qa->bai", wq, adv, phi)
              + nu * wq.sum() * es("bij,baj->bai", gu, g)
              - es("q,bq,bai->bai", wq, pq, g)
              + es("q,bq,bqi,bqa->bai", wq, tau, res, udg)
              + es("q,bq,b,bai->bai", wq, nul, div, g))
        rp = (es("q,b,qa->ba", wq, div, phi)
              + es("q,bq,bqa->ba", wq, tau, rdg))
        r = torch.cat([ru, rp[..., None]], -1) * detJ[:, None, None]
        F.index_add_(0, c.reshape(-1), r.reshape(-1, 4))
    return F
