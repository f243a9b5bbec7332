"""Poisson element kernel (the inlet fully-developed-flow solve).

Counterpart of the JAX package's ``forms/poisson.py``; the weak form of
reference NavierStokes/image2inlet.py:267-270: a = grad(u).grad(v) dx,
L = p v dx with p = 10 — the axial momentum balance for fully-developed
laminar flow in the inlet cross-section.  A plain callable (no analytic
tangent): assembly takes ``torch.func.jacfwd``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..assemble.assembly import affine_geometry
from ..fem.elements import element, quadrature


def make_poisson_kernel(
    cell: str, degree: int = 1, forcing: float = 10.0, qdeg: int = 2
) -> Callable:
    """Residual kernel r_a(w) = ∫ ∇w·∇φ_a − f φ_a dx over one element."""
    elem = element(cell, degree)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    dim = elem.dim

    def kernel(coords, w):
        dtype, dev = w.dtype, w.device
        phi = torch.as_tensor(phi_np, dtype=dtype, device=dev)    # (nq, nd)
        dphi = torch.as_tensor(dphi_np, dtype=dtype, device=dev)  # (nq, nd, dim)
        wq = torch.as_tensor(qr.weights, dtype=dtype, device=dev)
        _, invJ, detJ = affine_geometry(coords.to(dtype), dim)
        # physical gradients: g[q, a, i] = dphi[q, a, k] invJ[k, i]
        g = torch.einsum("qak,ki->qai", dphi, invJ)
        gu = torch.einsum("qai,a->qi", g, w)                       # (nq, dim)
        stiff = torch.einsum("q,qi,qai->a", wq, gu, g)
        load = forcing * torch.einsum("q,qa->a", wq, phi)
        return (stiff - load) * detJ

    return kernel
