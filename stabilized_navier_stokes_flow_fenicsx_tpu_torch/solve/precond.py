"""Jacobi-family preconditioners for the block-CSR and layered operators.

Counterparts of the JAX package's ``solve/precond.py::{identity_pc,
block_jacobi, scalar_jacobi}``.  ``block_jacobi``: with
the equal-order P1-P1 layout every mesh node carries a (dim+1)x(dim+1)
diagonal block coupling its velocity components and pressure; inverting
all of them is one batched 4x4 inverse.  Constrained (Dirichlet)
rows/cols are projected to identity so the preconditioner matches the
BC-projected operator.
"""

from __future__ import annotations

from typing import Callable

import torch


def identity_pc() -> Callable:
    return lambda x: x


def block_jacobi(diag_blocks: torch.Tensor, mask: torch.Tensor) -> Callable:
    """M^{-1} from node-diagonal blocks.

    diag_blocks: (n_rows, bs, bs); mask: (n_rows*bs,) 1 on free dofs.
    Returns a closure x -> D^{-1} x with each block projected
    (P_b D_b P_b + I - P_b) before inversion; x is taken in the blocks'
    dtype and returned in its own.
    """
    n, bs, _ = diag_blocks.shape
    mb = mask.reshape(n, bs).to(diag_blocks.dtype)
    P = mb[:, :, None] * mb[:, None, :]
    eye = torch.eye(bs, dtype=diag_blocks.dtype, device=diag_blocks.device)
    Dproj = diag_blocks * P + (1.0 - mb)[:, :, None] * eye
    Dinv = torch.linalg.inv(Dproj)

    def apply(x):
        xb = x.reshape(n, 1, bs).to(Dinv.dtype)
        return (Dinv * xb).sum(dim=-1).reshape(-1).to(x.dtype)

    return apply


def scalar_jacobi(diag: torch.Tensor, mask: torch.Tensor) -> Callable:
    """x -> x / d with d = diag on free dofs and 1 on constrained ones."""
    inv = 1.0 / (mask * diag + (1.0 - mask))

    def apply(x):
        return inv * x

    return apply
