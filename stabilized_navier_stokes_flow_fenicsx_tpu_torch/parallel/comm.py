"""The collectives of the multi-device layer, on ``torch.distributed``.

One process per rank.  The JAX package's collectives map so:

* ``lax.psum``            -> ``all_reduce_sum`` (``dist.all_reduce``),
* ``lax.ppermute`` of one plane to a neighbour -> ``fetch_next_plane``,
  ``push_top_plane`` and ``exchange_halo`` (``dist.batch_isend_irecv``),
* the partitioner's all-gather and reduce-scatter around a row-partitioned
  vector -> ``all_gather_cat`` and ``reduce_scatter_sum``.

Every function takes the process ``group`` (None: the default group).
With no process group initialised, or one rank, they are no-ops or return
zeros, so the same code serves a single process.  The backend follows the
tensors: ``gloo`` for CPU tensors, ``nccl`` for CUDA tensors
(``backend_for``).
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The ``torch.distributed`` backend for tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device, init_method: str, world_size: int, rank: int,
                       timeout_s: float = 300.0) -> None:
    """Initialise the default group with the backend of ``device`` (and
    bind this rank to its card first when ``device`` names one by
    index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device), init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if _active() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if _active() else 0


def _global(group, r: int) -> int:
    """The global rank of the group's rank r (what a P2POp names)."""
    return r if group is None else dist.get_global_rank(group, r)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on every rank (``lax.psum``)."""
    if world_size(group) == 1:
        return t
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _exchange(sends, recvs, group) -> None:
    """One batch of neighbour sends (tensor, group rank) and receives."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), _global(group, r),
                      group=group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, _global(group, r), group=group)
            for t, r in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _zeros(t: torch.Tensor) -> torch.Tensor:
    """Contiguous zeros of t's shape (a receive buffer)."""
    return torch.zeros_like(t, memory_format=torch.contiguous_format)


def fetch_next_plane(first: torch.Tensor, group=None) -> torch.Tensor:
    """Rank i receives rank i+1's ``first``; the last rank reads zeros
    (``ppermute`` with pairs (i+1, i))."""
    D, r = world_size(group), rank(group)
    out = _zeros(first)
    _exchange([(first, r - 1)] if r > 0 else [],
              [(out, r + 1)] if r < D - 1 else [], group)
    return out


def push_top_plane(top: torch.Tensor, group=None) -> torch.Tensor:
    """Rank i sends ``top`` to rank i+1; rank 0 receives zeros
    (``ppermute`` with pairs (i, i+1))."""
    D, r = world_size(group), rank(group)
    out = _zeros(top)
    _exchange([(top, r + 1)] if r < D - 1 else [],
              [(out, r - 1)] if r > 0 else [], group)
    return out


def exchange_halo(first: torch.Tensor, last: torch.Tensor, group=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both one-plane exchanges in one batch: returns (the previous rank's
    ``last``, the next rank's ``first``), zeros at the two ends."""
    D, r = world_size(group), rank(group)
    prev, nxt = _zeros(last), _zeros(first)
    sends, recvs = [], []
    if r > 0:
        sends.append((first, r - 1))
        recvs.append((prev, r - 1))
    if r < D - 1:
        sends.append((last, r + 1))
        recvs.append((nxt, r + 1))
    _exchange(sends, recvs, group)
    return prev, nxt


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equal-length slices joined along axis 0, on every rank."""
    D = world_size(group)
    if D == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(D)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


# the installed torch's single-tensor reduce-scatter: the newer name first
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or getattr(dist, "reduce_scatter_tensor", None)


def reduce_scatter_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks, each rank keeping its slice of
    axis 0 (length / ranks), by the installed torch's single-tensor
    reduce-scatter (gloo and nccl both have it).  A failure of the
    collective is raised, never worked around."""
    D = world_size(group)
    if D == 1:
        return t
    out = t.new_empty((t.shape[0] // D,) + tuple(t.shape[1:]))
    _REDUCE_SCATTER(out, t.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def destroy_process_group() -> None:
    if _active():
        dist.destroy_process_group()


def device_of(device: Optional[object]) -> torch.device:
    """``device`` or, when None, the card (raises without one)."""
    from ..config import default_device

    return default_device() if device is None else torch.device(device)
