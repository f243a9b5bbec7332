"""Generic element assembly: batched element kernels + index_add scatter.

Counterpart of the parts of the JAX package's ``assemble/assembly.py``
that the layered Stokes solve reaches.  Every form is an element residual
kernel ``kernel(coords_e (nv, gdim), w_e (ndl,)) -> r_e (ndl,)``; the
global residual is an ``index_add_`` over the batched kernel (the JAX
``segment_sum``), and element Jacobians come from the kernel's analytic
tangent or from ``torch.func.jacfwd`` under ``torch.func.vmap`` (the JAX
``jax.jacfwd`` under ``jax.vmap``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.linalg import det_small, inv_small

# cells per assembly chunk: bounds the batched-kernel intermediates (the
# same chunk the host plans pad to)
ASM_CHUNK = 65536


def affine_geometry(coords: torch.Tensor, dim: int):
    """Jacobian data for an affine simplex.

    coords: (nv, gdim) vertex coordinates (first dim+1 rows are vertices).
    Returns (J (dim, dim), invJ (dim, dim), absdetJ scalar) with
    J[i, k] = d x_i / d xi_k and invJ[k, i] = d xi_k / d x_i.
    """
    E = coords[1:dim + 1, :] - coords[0:1, :]    # rows = edge vectors
    J = E.T
    return J, inv_small(J), det_small(J).abs()


def cell_diameter(coords: torch.Tensor) -> torch.Tensor:
    """UFL CellDiameter: max vertex-vertex distance (longest edge)."""
    d = coords[:, None, :] - coords[None, :, :]
    return torch.sqrt((d * d).sum(-1).max())


def residual_of(kernel: Callable, ndofs: int, arrays,
                w: torch.Tensor) -> torch.Tensor:
    """Global residual r(w) = scatter(sum_e kernel_e).

    ``arrays`` carries ``cell_dofs`` (nc, ndl) and ``cell_coords``
    (nc, nv, gdim); padded cells point at the trash dof ``ndofs``, which
    reads 0 from w and absorbs their scatter.
    """
    w_ext = torch.cat([w, w.new_zeros(1)])
    cd_all, cc_all = arrays.cell_dofs, arrays.cell_coords
    out = w.new_zeros(ndofs + 1)
    batched = torch.func.vmap(kernel)
    for c0 in range(0, cd_all.shape[0], ASM_CHUNK):
        cd = cd_all[c0:c0 + ASM_CHUNK]
        r_e = batched(cc_all[c0:c0 + ASM_CHUNK], w_ext[cd])
        out.index_add_(0, cd.reshape(-1), r_e.reshape(-1))
    return out[:ndofs]


def _cell_jacobians(kernel: Callable, cell_coords, cell_dofs, w):
    """(nc, ndl, ndl) element Jacobians: the kernel's analytic tangent
    when present, else jacfwd of the kernel."""
    w_ext = torch.cat([w, w.new_zeros(1)])
    jac = kernel.jac
    if jac is not None:
        return torch.func.vmap(jac)(cell_coords, w_ext[cell_dofs])

    def cell_jac(coords, w_e):
        return torch.func.jacfwd(lambda ww: kernel(coords, ww))(w_e)

    return torch.func.vmap(cell_jac)(cell_coords, w_ext[cell_dofs])
