"""Element sharding of the generic block-CSR path over ranks.

Counterpart of the JAX package's ``parallel/shard.py`` on
``torch.distributed``, one process per rank; it stands in for the
reference's MPI domain decomposition (SURVEY.md 2.3: DOLFINx partitions
the mesh across ranks and exchanges ghost dofs inside PETSc, reference
NavierStokesChannelFlow.py:111, :57-66).

* ``sharded_newton``: the *elements* and the matrix nonzeros are sharded
  across the ranks; dof vectors stay replicated, and the ghost update is
  one all-reduce after each rank's ``index_add_`` (the JAX package's
  ``psum`` after ``segment_sum``).  No point-to-point, no ghost
  bookkeeping.
* ``spmd_newton_bcsr``: dof vectors ROW-PARTITIONED.  What XLA's
  partitioner inserted for the JAX package is written out here: an
  all-gather feeds the per-cell dof gather, the summed rows (and the
  summed nonzero blocks) are reduce-scattered, the Krylov dots and norms
  are all-reduced.

Padding scheme: cells (and nonzero blocks) are padded to a multiple of
the rank count; padded cells scatter into one extra dof/row segment that
is sliced off, and use copies of cell 0's coordinates so geometry stays
finite.  Every rank builds the whole host tables itself and uploads only
its slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..assemble.assembly import (ASM_CHUNK, AsmArrays, Assembler,
                                 matrix_values_of, residual_of)
from ..solve.newton import NewtonResult, newton_solve
from ..solve.precond import block_jacobi
from ..utils.device import host_array, upload
from . import comm


class ShardedArrays(NamedTuple):
    """This rank's slices of the padded assembly tables."""

    cell_dofs: torch.Tensor      # (nc_pad / D, ndl)
    cell_coords: torch.Tensor    # (nc_pad / D, nv, gdim)
    ell_pos: torch.Tensor        # (nc_pad / D, nbl, nbl)
    indices: torch.Tensor        # (nnzb_pad / D,)
    row_ids: torch.Tensor        # (nnzb_pad / D,)
    diag_pos: torch.Tensor       # (n_rows,) whole on every rank


@dataclasses.dataclass
class ShardedProblem:
    group: object                # the process group (None: the default)
    arrays: ShardedArrays
    ndofs: int
    nnzb: int
    nnzb_pad: int
    bs: int
    n_rows: int
    dtype: torch.dtype = torch.float64

    @property
    def device(self) -> torch.device:
        return self.arrays.cell_coords.device


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    pad = n - x.shape[0]
    if pad == 0:
        return x
    if np.isscalar(fill):
        tile = np.full((pad,) + x.shape[1:], fill, dtype=x.dtype)
    else:
        tile = np.broadcast_to(fill, (pad,) + x.shape[1:]).astype(x.dtype)
    return np.concatenate([x, tile], axis=0)


def _mine(x: np.ndarray, group) -> np.ndarray:
    """This rank's slice of axis 0 (length a multiple of the rank count)."""
    D, r = comm.world_size(group), comm.rank(group)
    n = x.shape[0] // D
    return x[r * n:(r + 1) * n]


def make_sharded_problem(asm: Assembler, group=None,
                         device=None) -> ShardedProblem:
    """Shard an Assembler's tables over the ranks of ``group``: this
    rank's slices on ``device`` (the card when None)."""
    device = comm.device_of(device)
    nd = comm.world_size(group)
    pat = asm.pattern
    cd = host_array(asm.arrays.cell_dofs).astype(np.int32)
    cc = host_array(asm.arrays.cell_coords)
    nc, nnzb = cd.shape[0], pat.nnzb
    nc_pad = -(-nc // nd) * nd
    nnzb_pad = -(-nnzb // nd) * nd
    # padded cells scatter into the extra dof segment (ndofs) and the
    # extra nnz segment (nnzb); coords copy cell 0 (finite geometry)
    host = dict(
        cell_dofs=_pad_to(cd, nc_pad, np.int32(asm.ndofs)),
        cell_coords=_pad_to(cc, nc_pad, cc[0]),
        ell_pos=_pad_to(np.asarray(pat.ell_pos), nc_pad, np.int32(nnzb)),
        indices=_pad_to(np.asarray(pat.indices), nnzb_pad, np.int32(0)),
        row_ids=_pad_to(np.asarray(pat.row_ids), nnzb_pad,
                        np.int32(pat.n_rows)))
    arrays = ShardedArrays(
        diag_pos=upload(pat.diag_pos, device),
        **{k: upload(_mine(v, group), device) for k, v in host.items()})
    return ShardedProblem(
        group=group, arrays=arrays, ndofs=asm.ndofs, nnzb=nnzb,
        nnzb_pad=nnzb_pad, bs=pat.bs, n_rows=pat.n_rows, dtype=asm.dtype)


# ---- sharded assembly/SpMV primitives -------------------------------------


def _local_residual(kernel, ndofs, arrays, w, group):
    """This rank's cells into the whole residual, summed over the ranks
    (padded cells scatter into the trash dof ``ndofs``)."""
    return comm.all_reduce_sum(residual_of(kernel, ndofs, arrays, w), group)


def _local_jac_values(kernel, nnzb_true, nnzb_pad, bs, arrays, w, group):
    """Whole, summed block values padded to nnzb_pad (zeros beyond)."""
    v = matrix_values_of(kernel, nnzb_pad + 1, bs, arrays, w)
    # segment nnzb_true absorbs the padded cells' scatter; clear it
    v[nnzb_true] = 0.0
    return comm.all_reduce_sum(v[:nnzb_pad], group)


def _local_matvec(n_rows, values_pad, indices, row_ids, x, group):
    """SpMV with the nonzeros sharded: each rank handles its slice of the
    (padded) nnz axis, taking the matching slice of the whole values."""
    bs = values_pad.shape[-1]
    sz = indices.shape[0]                      # this rank's slice length
    my = comm.rank(group)
    vloc = values_pad[my * sz:(my + 1) * sz]
    contrib = torch.einsum("nij,nj->ni", vloc, x.reshape(-1, bs)[indices])
    yb = x.new_zeros((n_rows + 1, bs)).index_add_(0, row_ids, contrib)
    return comm.all_reduce_sum(yb[:n_rows].reshape(-1), group)


def sharded_newton(
    prob: ShardedProblem,
    kernel: Callable,
    mask,
    g,
    w0,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 30,
    ksp_rtol: float = 1e-8,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 40,
) -> NewtonResult:
    """Full Newton solve with element-sharded assembly and nnz-sharded
    SpMV.  Every rank runs the (replicated) Krylov vector algebra and
    contributes its element/nnz slice through all-reduces; mask, g and w0
    are the whole host vectors and ``NewtonResult.x`` is whole on every
    rank."""
    a, grp = prob.arrays, prob.group
    ndofs, nnzb, bs, n_rows = prob.ndofs, prob.nnzb, prob.bs, prob.n_rows

    def vec(v):
        return torch.as_tensor(host_array(v), dtype=prob.dtype,
                               device=prob.device)

    mask_, g_, w0_ = vec(mask), vec(g), vec(w0)

    def residual(w):
        r = _local_residual(kernel, ndofs, a, w, grp)
        return mask_ * r + (1.0 - mask_) * (w - g_)

    def jac_values(w):
        return _local_jac_values(kernel, nnzb, prob.nnzb_pad, bs, a, w, grp)

    def make_op(values):
        def op(x):
            y = _local_matvec(n_rows, values, a.indices, a.row_ids,
                              mask_ * x, grp)
            return mask_ * y + (1.0 - mask_) * x
        return op

    def make_pc(values):
        return block_jacobi(values[a.diag_pos], mask_)

    return newton_solve(
        residual, jac_values, make_op, make_pc, w0_,
        rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
        ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts)


# ---- row-partitioned dof vectors -------------------------------------------


def _pad_axis(x, n: int, fill) -> np.ndarray:
    return _pad_to(host_array(x), n, fill)


def spmd_pad_problem(asm: Assembler, n_devices: int):
    """Pad a BCSR problem so every sharded axis divides the rank count:
    dofs are extended with Dirichlet identity rows pinned to 0 (the
    layered path's plane-padding trick, layered_shard.py), nnz entries
    with trash blocks scattering into a padded (masked) row, cells with
    the existing trash-cell scheme.  Returns ({name: host array} with
    AsmArrays' names, ndofs_pad, nnzb_pad, n_rows_pad).

    Trash cells gather/scatter at index ``asm.ndofs``, a real, masked,
    zero-pinned row, and trash nnz blocks carry garbage values whose rows
    the BC mask annihilates.
    """
    D = int(n_devices)
    pat = asm.pattern
    bs = pat.bs
    unit = bs * D                       # ndofs_pad % D == n_rows_pad % D == 0
    ndofs_pad = -(-(asm.ndofs + 1) // unit) * unit
    n_rows_pad = ndofs_pad // bs
    nnzb_pad = -(-pat.nnzb // D) * D
    cd = host_array(asm.arrays.cell_dofs).astype(np.int32)
    cc = host_array(asm.arrays.cell_coords)
    nc = cd.shape[0]
    cunit = np.lcm(ASM_CHUNK, D) if nc > ASM_CHUNK else D
    nc_pad = -(-nc // cunit) * cunit
    arrays = dict(
        cell_dofs=_pad_axis(cd, nc_pad, np.int32(asm.ndofs)),
        cell_coords=_pad_axis(cc, nc_pad, cc[0]),
        indices=_pad_axis(pat.indices, nnzb_pad, np.int32(0)),
        row_ids=_pad_axis(pat.row_ids, nnzb_pad, np.int32(pat.n_rows)),
        ell_pos=_pad_axis(pat.ell_pos, nc_pad, np.int32(pat.nnzb)),
        diag_pos=_pad_axis(pat.diag_pos, n_rows_pad, np.int32(0)),
    )
    return arrays, ndofs_pad, nnzb_pad, n_rows_pad


def spmd_newton_bcsr(
    asm: Assembler,
    kernel: Callable,
    mask,
    g,
    w0,
    group=None,
    device=None,
    **tols,
) -> NewtonResult:
    """Newton with ROW-PARTITIONED dof vectors on the generic BCSR path.

    ``sharded_newton`` above divides the element/nnz work but keeps every
    dof vector whole on every rank.  Here w, mask, g and with them the
    Krylov basis (the dominant vector memory at restart 50) are sharded:
    each rank owns ``ndofs_pad / D`` consecutive entries.  An all-gather
    feeds the per-cell dof gather and the SpMV's column gather, the summed
    rows and the summed nonzero blocks are reduce-scattered, each rank
    keeps the node-diagonal blocks of its own rows, and the Krylov dots
    and norms are all-reduced.  ``NewtonResult.x`` is this rank's
    ``ndofs_pad / D`` entries; joined (``comm.all_gather_cat``), slice
    ``[:asm.ndofs]`` for the solution (padded rows are Dirichlet-pinned
    zeros).

    Stands in for the reference's distributed PETSc Vec ownership
    (reference NavierStokesChannelFlow.py:111, :153-154: each MPI rank
    owns a contiguous dof range) on unstructured meshes; the
    extruded-channel main path has its own variant
    (parallel/layered_shard.py) where the plane structure makes the halo a
    single neighbour exchange.
    """
    device = comm.device_of(device)
    D, r = comm.world_size(group), comm.rank(group)
    host, ndofs_pad, nnzb_pad, n_rows_pad = spmd_pad_problem(asm, D)
    bs = asm.pattern.bs
    a = AsmArrays.from_numpy({k: _mine(v, group) for k, v in host.items()},
                             device, asm.dtype)
    # the node-diagonal blocks this rank's nnz slice holds, and their rows
    nz0 = r * (nnzb_pad // D)
    is_diag = host["diag_pos"][np.minimum(_mine(host["row_ids"], group),
                                          n_rows_pad - 1)] \
        == nz0 + np.arange(nnzb_pad // D)
    # the padded rows' diag_pos (0) marks no block: they stay zero blocks,
    # which block_jacobi projects to the identity under their mask of 0
    is_diag &= _mine(host["row_ids"], group) < asm.pattern.n_rows
    diag_at = upload(np.nonzero(is_diag)[0], device)
    diag_row = upload(_mine(host["row_ids"], group)[is_diag], device)
    pad = ndofs_pad - asm.ndofs

    def vec(v):
        v = host_array(v)
        return torch.as_tensor(
            _mine(np.concatenate([v, np.zeros(pad, v.dtype)]), group),
            dtype=asm.dtype, device=device)

    mask_, g_, w0_ = vec(mask), vec(g), vec(w0)

    def reduce(t):
        return comm.all_reduce_sum(t, group)

    def residual(w):
        r_all = residual_of(kernel, ndofs_pad, a,
                            comm.all_gather_cat(w, group))
        return mask_ * comm.reduce_scatter_sum(r_all, group) \
            + (1.0 - mask_) * (w - g_)

    def jac_values(w):
        # trash cells add into block ``pattern.nnzb``: one past the end
        # when no nnz padding was needed, hence the extra block
        v = matrix_values_of(kernel, nnzb_pad + 1, bs, a,
                             comm.all_gather_cat(w, group))
        return comm.reduce_scatter_sum(v[:nnzb_pad], group)

    def make_op(values):
        def op(x):
            xb = comm.all_gather_cat(mask_ * x, group).reshape(-1, bs)
            contrib = torch.einsum("nij,nj->ni", values, xb[a.indices])
            yb = x.new_zeros((n_rows_pad, bs)).index_add_(
                0, a.row_ids, contrib)
            y = comm.reduce_scatter_sum(yb, group).reshape(-1)
            return mask_ * y + (1.0 - mask_) * x
        return op

    def make_pc(values):
        d = values.new_zeros((n_rows_pad, bs, bs))
        d[diag_row] = values[diag_at]
        return block_jacobi(comm.reduce_scatter_sum(d, group), mask_)

    return newton_solve(residual, jac_values, make_op, make_pc, w0_,
                        reduce=reduce if D > 1 else None, **tols)
