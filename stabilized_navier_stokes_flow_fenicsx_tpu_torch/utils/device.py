"""numpy -> torch upload of host-built tables, and device helpers."""

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


def host_array(t) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def row_ptr_of(row_ids: np.ndarray, n_rows: int) -> np.ndarray:
    """CSR row pointer (n_rows + 1,) of a row-sorted pair list."""
    counts = np.bincount(np.asarray(row_ids, np.int64), minlength=n_rows)
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr


def sync(device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so a host
    clock read after it times the work, not its launch."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_count() -> int:
    """Cards in use: every visible CUDA device, else 1 (the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
