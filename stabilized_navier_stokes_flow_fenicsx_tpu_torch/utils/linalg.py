"""Closed-form 2x2 and 3x3 determinant and inverse (element geometry),
and a dense QR solve.

Counterpart of the JAX package's ``utils/linalg.py``.  ``det_small`` and
``inv_small`` serve the triangle and tetrahedron element Jacobians: pure
elementwise arithmetic, batched over any leading axes and differentiable
under ``torch.func``.
"""

from __future__ import annotations

import torch


def _size(A: torch.Tensor) -> int:
    n = A.shape[-1]
    if A.shape[-2:] not in ((2, 2), (3, 3)):
        raise ValueError(f"expected (..., 2, 2) or (..., 3, 3), got "
                         f"{tuple(A.shape)}")
    return n


def det_small(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., n, n), n in {2, 3}."""
    if _size(A) == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def inv_small(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., n, n), n in {2, 3}, by the adjugate."""
    d = det_small(A)
    if A.shape[-1] == 2:
        adj = torch.stack([
            torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
            torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
        ], dim=-2)
        return adj / d[..., None, None]

    def cof(i0, i1, j0, j1):
        return A[..., i0, j0] * A[..., i1, j1] - A[..., i0, j1] * A[..., i1, j0]

    adj = torch.stack([
        torch.stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)],
                    dim=-1),
        torch.stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)],
                    dim=-1),
        torch.stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)],
                    dim=-1),
    ], dim=-2)
    return adj / d[..., None, None]


def solve_dense_qr(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense solve A x = b via QR: R x = Q^T b by back substitution."""
    Q, R = torch.linalg.qr(A)
    rhs = Q.mT @ b
    if b.dim() == 1:
        return torch.linalg.solve_triangular(R, rhs[:, None],
                                             upper=True)[:, 0]
    return torch.linalg.solve_triangular(R, rhs, upper=True)
