"""Closed-form 3x3 determinant and inverse (element geometry).

Counterpart of the JAX package's ``utils/linalg.py`` for the 3x3 element
Jacobians: pure elementwise arithmetic, batched over any leading axes and
differentiable under ``torch.func``.
"""

from __future__ import annotations

import torch


def _check3(A: torch.Tensor) -> None:
    if A.shape[-2:] != (3, 3):
        raise ValueError(f"expected (..., 3, 3), got {tuple(A.shape)}")


def det_small(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3)."""
    _check3(A)
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def inv_small(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) by the adjugate."""
    d = det_small(A)

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
