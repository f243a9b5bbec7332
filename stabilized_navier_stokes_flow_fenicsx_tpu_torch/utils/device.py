"""numpy -> torch upload of host-built tables."""

from __future__ import annotations

import numpy as np
import torch


def upload(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device``: integer tables become
    int64 (torch's index dtype), floating arrays keep their dtype."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def row_ptr_of(row_ids: np.ndarray, n_rows: int) -> np.ndarray:
    """CSR row pointer (n_rows + 1,) of a row-sorted pair list."""
    counts = np.bincount(np.asarray(row_ids, np.int64), minlength=n_rows)
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr
