"""Stabilized Stokes element kernel (pressure-stabilized P1-P1).

Counterpart of the JAX package's ``forms/stokes.py``; replicates the
channel Stokes weak form of reference NavierStokesChannelFlow.py:160-172:

    a = grad(u):grad(v) - p div(v) + q div(u) + mu_T grad(p).grad(q)
    mu_T = 0.2 h^2                       (h = UFL CellDiameter)
    L = f.v - mu_T f.grad(q),  f = 0

and the nu-scaled lid-driven variant (mu_T = mu_T_coeff h^2 / (4 nu)).
The kernel has no analytic tangent: assembly takes ``torch.func.jacfwd``.
Local dof layout is node-major [u_x, u_y, u_z, p] per node.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..assemble.assembly import affine_geometry, cell_diameter
from ..fem.elements import element, quadrature
from ..utils.kernelbase import ElementKernel, param_tensors


def make_stokes_kernel(
    cell: str,
    nu: float = 1.0,
    mu_T_coeff: float = 0.2,
    nu_scaled_stab: bool = False,
    qdeg: int = 2,
    forcing: Optional[np.ndarray] = None,
) -> ElementKernel:
    """Residual kernel for the stabilized Stokes form on P1-P1; (nu,
    mu_T_coeff, forcing) are runtime parameters."""
    elem = element(cell, 1)
    f_np = np.zeros(elem.dim) if forcing is None \
        else np.asarray(forcing, float)
    return ElementKernel(_stokes_fn(cell, nu_scaled_stab, qdeg), None,
                         (nu, mu_T_coeff, f_np))


@functools.lru_cache(maxsize=None)
def _stokes_fn(cell: str, nu_scaled_stab: bool, qdeg: int):
    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    dim = elem.dim
    nv = elem.ndof
    bs = dim + 1

    def kernel(params, coords, w):
        dtype, dev = w.dtype, w.device
        nu, mu_T_coeff, fvec = param_tensors(params, w)
        phi = torch.as_tensor(phi_np, dtype=dtype, device=dev)
        dphi = torch.as_tensor(dphi_np, dtype=dtype, device=dev)
        wq = torch.as_tensor(qr.weights, dtype=dtype, device=dev)
        coords = coords.to(dtype)

        _, invJ, detJ = affine_geometry(coords, dim)
        h = cell_diameter(coords)
        mu_T = (mu_T_coeff * h * h / (4.0 * nu)) if nu_scaled_stab \
            else (mu_T_coeff * h * h)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]

        g = torch.einsum("qak,ki->qai", dphi, invJ)         # (nq, nv, dim)
        grad_u = torch.einsum("qaj,ai->qij", g, u_n)        # du_i/dx_j
        grad_p = torch.einsum("qai,a->qi", g, p_n)
        div_u = torch.einsum("qii->q", grad_u)
        p_q = torch.einsum("qa,a->q", phi, p_n)

        r_u = nu * torch.einsum("q,qij,qaj->ai", wq, grad_u, g)
        r_u = r_u - torch.einsum("q,q,qai->ai", wq, p_q, g)
        r_u = r_u - torch.einsum("q,i,qa->ai", wq, fvec, phi)
        r_p = torch.einsum("q,q,qa->a", wq, div_u, phi)
        r_p = r_p + mu_T * torch.einsum("q,qi,qai->a", wq, grad_p, g)
        r_p = r_p + mu_T * torch.einsum("q,i,qai->a", wq, fvec, g)

        r = torch.cat([r_u, r_p[:, None]], dim=1).reshape(-1)
        return r * detJ

    return kernel
