"""Taylor-Hood (P2-P1) Stokes element kernel — unstabilized saddle point.

Counterpart of the JAX package's ``forms/stokes_th.py``.  Replicates
reference StokesFlow/DuctStokesFlow.py:188-192:

    a = inner(grad(u), grad(v)) + inner(p, div(v)) - inner(div(u), q)

(note the sign convention differs from the channel form: +p div v and
-div u q).  Velocity is vector P2 (10 nodes on tets, 6 on triangles),
pressure P1 on the vertices; local layout = velocity node-major then
pressure — the stacked mixed layout of fem/space.py for non-equal-order
pairs.  No pressure stabilization: this pair is inf-sup stable.  A plain
callable (no analytic tangent): assembly takes ``torch.func.jacfwd``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..assemble.assembly import affine_geometry
from ..fem.elements import element, quadrature


def make_stokes_th_kernel(
    cell: str,
    nu: float = 1.0,
    qdeg: int = 3,
    symmetric_signs: bool = False,
) -> Callable:
    """symmetric_signs=True negates the continuity rows (same solution),
    making the assembled matrix symmetric indefinite [[A, B], [B^T, 0]].
    The Taylor-Hood path solves it with fieldsplit FGMRES
    (solve/stokes_th.py); the symmetric form also feeds the documented
    MINRES alternative (solve/krylov.py::minres) for SPD-preconditioned
    saddle points."""
    elem_v = element(cell, 2)
    elem_p = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phiv_np, dphiv_np = elem_v.tabulate(qr.points)
    phip_np, _ = elem_p.tabulate(qr.points)
    dim = elem_v.dim
    nv = elem_v.ndof          # velocity scalar dofs per cell
    es = torch.einsum

    def kernel(coords, w):
        dtype, dev = w.dtype, w.device
        # dphiv (nq, nv, dim), phip (nq, np)
        dphiv = torch.as_tensor(dphiv_np, dtype=dtype, device=dev)
        phip = torch.as_tensor(phip_np, dtype=dtype, device=dev)
        wq = torch.as_tensor(qr.weights, dtype=dtype, device=dev)

        _, invJ, detJ = affine_geometry(coords.to(dtype), dim)
        u_n = w[: nv * dim].reshape(nv, dim)
        p_n = w[nv * dim:]

        g = es("qak,ki->qai", dphiv, invJ)
        grad_u = es("qaj,ai->qij", g, u_n)
        div_u = es("qii->q", grad_u)
        p_q = es("qa,a->q", phip, p_n)

        # + nu grad(u):grad(v) + p div(v)
        r_u = nu * es("q,qij,qaj->ai", wq, grad_u, g)
        r_u = r_u + es("q,q,qai->ai", wq, p_q, g)
        # - div(u) q   (reference sign; negated when symmetric_signs)
        r_p = -es("q,q,qa->a", wq, div_u, phip)
        if symmetric_signs:
            r_p = -r_p

        return torch.cat([r_u.reshape(-1), r_p]) * detJ

    return kernel
