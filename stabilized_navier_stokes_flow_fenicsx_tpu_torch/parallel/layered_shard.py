"""Plane-sharded layered operator: the main path across ranks.

Counterpart of the JAX package's ``parallel/layered_shard.py`` on
``torch.distributed``, one process per rank.  The *plane* axis of the
extruded channel is the rank axis:

* dof vectors are row-partitioned: each rank owns a contiguous block of
  ``Lq`` planes;
* the value tensor (bs, bs, 3, E, Lp) is sharded on its plane axis;
* the cell tables are slab-partitioned (``build_slab_layered``): each rank
  holds only the cells whose base plane lies in its slab, with dof and
  scatter ids in slab-local numbering.  Each rank assembles its own cells
  into an (Lq+1)-plane block, and the one boundary plane of rows is
  pushed to the next rank (cells touch exactly planes lb and lb+1, so the
  halo is one plane in one direction);
* the SpMV is kernel K1 on the slab (``SlabOperand``): the slab's planes
  with one halo plane of x below and one above, fetched per call from the
  two neighbours (the JAX package leaves these shifted reads to XLA's
  partitioner);
* the Krylov dot products and norms are all-reduced
  (``solve/krylov.py``'s ``reduce``).

Every rank builds the host mesh and tables itself (deterministic numpy)
and uploads only its slab.  Plane padding: Lp is rounded up to a multiple
of the rank count; padded planes are Dirichlet identity rows (mask 0,
g 0) that never couple back.

Preconditioners: node-block Jacobi (purely local) or, with ``pc="mg"``,
the aggregation V-cycle with level 0 plane-sharded and the coarse levels
replicated (``solve/mg.py::SlabFine``).

``padded_planes`` here rounds a plane count up to the rank count;
``assemble/layered_spmv.py::padded_planes`` is another function, K1's
padding of a plane row to whole 16-byte vectors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..assemble.assembly import ASM_CHUNK, matrix_values_of, residual_of
from ..assemble.layered import LayeredArrays, layered_diag_blocks
from ..assemble.layered_spmv import LayeredOperand, project_values
from ..config import default_dtype
from ..solve.newton import NewtonResult, newton_solve
from ..solve.precond import block_jacobi
from ..utils.device import host_array, upload
from . import comm


def padded_planes(n_planes: int, n_devices: int) -> int:
    """``n_planes`` rounded up to a multiple of the rank count (not K1's
    ``assemble/layered_spmv.py::padded_planes``)."""
    return -(-n_planes // n_devices) * n_devices


def pad_mask_g(mask_np: np.ndarray, g_np: np.ndarray, ndofs_pad: int):
    """Extend BC mask/values over the padded planes: constrained to 0."""
    pad = ndofs_pad - mask_np.shape[0]
    if pad == 0:
        return mask_np, g_np
    return (np.concatenate([mask_np, np.zeros(pad, mask_np.dtype)]),
            np.concatenate([g_np, np.zeros(pad, g_np.dtype)]))


class SlabArrays(NamedTuple):
    """Slab-partitioned cell data.

    From ``build_slab_layered``: host arrays stacked (D*ncs, ...) with
    rank d owning rows [d*ncs, (d+1)*ncs).  From ``shard_layered_inputs``:
    this rank's ncs rows as tensors on its device.  Dof and segment ids
    are SLAB-LOCAL: dofs index the (Lq+1)-plane extended block [own slab
    planes + the next slab's first plane], segments the (Lq+1)-plane local
    value tensor.  Trash rows (count padding) point at the local trash
    dof/segment.
    """

    cell_dofs: object        # (ncs, ndl) slab-local dof ids
    cell_coords: object      # (ncs, nv, 3)
    ell_pos: object          # (ncs, nbl, nbl) slab-local segment ids


def build_slab_layered(lp, n_devices: int):
    """Host-side slab partition of the layered cell tables.

    Each cell spans planes (lb, lb+1); it is assigned to the slab owning
    lb, so a rank's cells scatter rows only into its own planes plus the
    FIRST plane of the next slab (the one-plane halo of
    ``make_slab_assembly``).  Returns (SlabArrays of numpy arrays, meta);
    meta carries the per-rank true cell counts.  ``ncs`` is rounded to
    whole assembly chunks, as the JAX package's tables are.
    """
    D = int(n_devices)
    Lp, n2d, bs, E = lp.n_planes, lp.n2d, lp.bs, lp.E
    if Lp % D != 0:
        raise ValueError(f"{Lp} planes do not divide over {D} ranks: build "
                         f"the pattern with padded_planes(Lp, {D})")
    Lq = Lp // D
    ndofs = lp.ndofs
    cd = host_array(lp.arrays.cell_dofs)
    cc = host_array(lp.arrays.cell_coords)
    ep = host_array(lp.arrays.ell_pos)
    real = cd[:, 0] < ndofs              # drop the chunk-padding cells
    cd, cc, ep = cd[real], cc[real], ep[real]
    lb = (cd.min(axis=1) // bs) // n2d   # base plane of each cell
    s_of = np.minimum(lb // Lq, D - 1)
    counts = np.bincount(s_of, minlength=D)
    ncs = int(counts.max())
    if ncs > ASM_CHUNK:
        ncs = -(-ncs // ASM_CHUNK) * ASM_CHUNK
    ndofs_ext = (Lq + 1) * n2d * bs
    nseg_ext = 3 * E * (Lq + 1)
    ndl = cd.shape[1]
    out_cd = np.full((D, ncs, ndl), ndofs_ext, np.int32)
    out_cc = np.broadcast_to(cc[0], (D, ncs) + cc.shape[1:]).copy()
    out_ep = np.full((D, ncs) + ep.shape[1:], nseg_ext, np.int32)
    for s in range(D):
        m = s_of == s
        k = int(counts[s])
        out_cd[s, :k] = cd[m] - s * Lq * n2d * bs
        out_cc[s, :k] = cc[m]
        l_row = ep[m] % Lp
        de = ep[m] // Lp
        out_ep[s, :k] = de * (Lq + 1) + (l_row - s * Lq)
    slab = SlabArrays(
        cell_dofs=out_cd.reshape(D * ncs, ndl),
        cell_coords=out_cc.reshape((D * ncs,) + cc.shape[1:]),
        ell_pos=out_ep.reshape((D * ncs,) + ep.shape[1:]))
    meta = dict(Lq=Lq, ncs=ncs, counts=counts, ndofs_ext=ndofs_ext,
                nseg_ext=nseg_ext)
    return slab, meta


def _fetch_next_plane(w_local: torch.Tensor, n2d_bs: int, group=None):
    """Halo fetch: the next rank's first plane (the last rank reads
    zeros)."""
    return comm.fetch_next_plane(w_local[:n2d_bs], group)


def _push_top_plane(top: torch.Tensor, group=None):
    """Halo push: this rank's extra top plane of row sums goes to the next
    rank (rank 0 receives zeros)."""
    return comm.push_top_plane(top, group)


def make_slab_assembly(kernel, n2d: int, Lq: int, bs: int, E: int,
                       group=None):
    """(residual_fn, values_fn) with slab-sharded element work.

    residual_fn(slab, w_local) -> this rank's Lq planes of the global
    residual; values_fn(slab, w_local) -> its (bs, bs, 3, E, Lq) values.
    Both run the generic per-cell assembly (``residual_of``,
    ``matrix_values_of``) on the rank's cells over the (Lq+1)-plane
    extended block, then reconcile the single boundary plane with the
    next rank.
    """
    nb = n2d * bs
    ndofs_ext = (Lq + 1) * nb
    nseg_ext = 3 * E * (Lq + 1)

    def residual_fn(slab: SlabArrays, w_local: torch.Tensor):
        w_ext = torch.cat([w_local, _fetch_next_plane(w_local, nb, group)])
        r_ext = residual_of(kernel, ndofs_ext, slab, w_ext)
        recv = _push_top_plane(r_ext[Lq * nb:], group)
        r = r_ext[:Lq * nb].clone()
        r[:nb] += recv
        return r

    def values_fn(slab: SlabArrays, w_local: torch.Tensor):
        w_ext = torch.cat([w_local, _fetch_next_plane(w_local, nb, group)])
        # segment id (d*E + e)*(Lq+1) + l; the trash segment nseg_ext
        # absorbs the count-padding cells and is sliced off
        V_ext = matrix_values_of(kernel, nseg_ext + 1, bs, slab,
                                 w_ext)[:nseg_ext]
        V_ext = V_ext.reshape(3 * E, Lq + 1, bs * bs).permute(2, 0, 1)
        recv = _push_top_plane(V_ext[:, :, Lq], group)
        V = V_ext[:, :, :Lq].clone()
        V[:, :, 0] += recv
        return V.reshape(bs, bs, 3, E, Lq)

    return residual_fn, values_fn


class SlabOperand:
    """The BC-projected operator m * A (m * x) + (1 - m) * x on this
    rank's slab, through K1.

    ``LayeredOperand`` on the slab's Lq planes plus one halo plane below
    and one above, with zero value rows on the halo planes.  A call
    fetches the two halo planes of x from the neighbours, runs the
    operand (kernel K1 on a CUDA tensor, its plain version on a CPU
    tensor) and keeps the interior.  ``mask_ext`` is the mask over the
    Lq+2 planes: the halo columns are multiplied by the NEIGHBOURS' mask
    planes (``halo_extend`` of the local mask, once at setup); at the two
    ends of the channel the halo of x is zero, the global x[-1] = x[Lp] =
    0.  ``masks`` are the local mask in float64 and float32, as K1's
    operand keeps them.
    """

    def __init__(self, values: torch.Tensor, cols, row_ptr, n2d: int,
                 mask_ext: torch.Tensor, group=None, dtype=None):
        Lq = values.shape[4]
        self.nb = n2d * values.shape[0]
        self.group = group
        self.inner = LayeredOperand(_halo_values(values), cols, row_ptr,
                                    n2d, mask=mask_ext, dtype=dtype)
        self.masks = {t: m[self.nb:-self.nb]
                      for t, m in self.inner.masks.items()}
        self.shape = (Lq * self.nb,)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        nb = self.nb
        prev, nxt = comm.exchange_halo(x[:nb], x[-nb:], self.group)
        return self.inner(torch.cat([prev, x, nxt]))[nb:-nb]


def _halo_values(values: torch.Tensor) -> torch.Tensor:
    """(bs, bs, 3, E, Lq) -> (bs, bs, 3, E, Lq+2) with zero planes at the
    two ends."""
    Lq = values.shape[4]
    ext = values.new_zeros(tuple(values.shape[:4]) + (Lq + 2,))
    ext[..., 1:Lq + 1] = values
    return ext


def halo_extend(v_local: torch.Tensor, nb: int, group=None) -> torch.Tensor:
    """A slab vector with the previous rank's last plane before it and the
    next rank's first plane after it (zeros at the ends of the channel)."""
    prev, nxt = comm.exchange_halo(v_local[:nb], v_local[-nb:], group)
    return torch.cat([prev, v_local, nxt])


def shard_layered_inputs(lp, mask, g, w0, group=None, device=None,
                         dtype=None):
    """This rank's share of the problem on ``device``: vectors
    plane-partitioned, cell data SLAB-partitioned (``build_slab_layered``:
    element work and cell-table memory divide by the rank count), the
    small 2D pattern tables whole.  ``lp`` holds host tables (built with
    padded planes; ``build_layered`` without a device); mask, g and w0 are
    the whole padded host vectors.  Returns (arrays, slab, meta, (mask_s,
    g_s, w0_s))."""
    device = comm.device_of(device)
    dtype = default_dtype() if dtype is None else dtype
    D, r = comm.world_size(group), comm.rank(group)
    slab_np, meta = build_slab_layered(lp, D)
    ncs = meta["ncs"]
    rows = slice(r * ncs, (r + 1) * ncs)
    slab = SlabArrays(
        cell_dofs=upload(slab_np.cell_dofs[rows], device),
        cell_coords=upload(slab_np.cell_coords[rows], device),
        ell_pos=upload(slab_np.ell_pos[rows], device))
    # only the small 2D pattern tables are whole on every rank; the global
    # cell tables are not shipped (slab holds this rank's part)
    a = lp.arrays
    z = torch.zeros(0, dtype=torch.int64, device=device)
    arrays = LayeredArrays(
        cell_dofs=z, cell_coords=z, ell_pos=z, cols=a.cols.to(device),
        row_ids=a.row_ids.to(device), row_ptr=a.row_ptr.to(device),
        diag_pos=a.diag_pos.to(device), sasm=None)
    n = meta["Lq"] * lp.n2d * lp.bs
    dofs = slice(r * n, (r + 1) * n)

    def vec(v):
        return torch.as_tensor(np.asarray(v)[dofs], dtype=dtype,
                               device=device)

    return arrays, slab, meta, (vec(mask), vec(g), vec(w0))


def _slab_hierarchy(lp, mask, mg_levels: int, Lq: int, rank: int, device):
    """The multigrid hierarchy with level 0's restriction maps cut to this
    rank's planes: ``seg_map`` is (3E, Lp) plane-minor and ``node_map``
    plane-major, so both cuts are plane ranges.  The coarse levels are
    whole on every rank."""
    import dataclasses

    from ..solve.mg import MGHierarchy, build_mg_hierarchy

    hier = build_mg_hierarchy(
        lp.rows2d, lp.cols2d, lp.n2d, lp.n_planes,
        np.asarray(mask, np.float32), lp.bs, n_levels=mg_levels,
        device="cpu")
    if not hier.levels:
        raise ValueError("pc='mg' needs at least one coarse level")
    planes = slice(rank * Lq, (rank + 1) * Lq)
    lev0 = hier.levels[0]
    lev0 = dataclasses.replace(
        lev0,
        seg_map=lev0.seg_map.reshape(3 * lp.E, lp.n_planes)[:, planes]
        .reshape(-1),
        node_map=lev0.node_map.reshape(lp.n_planes, lp.n2d)[planes]
        .reshape(-1))
    levels = tuple(
        type(lv)(**{f.name: getattr(lv, f.name).to(device)
                    for f in dataclasses.fields(lv)})
        for lv in (lev0,) + hier.levels[1:])
    return MGHierarchy(levels=levels, dims=hier.dims)


def sharded_newton_layered(
    kernel: Callable,
    lp,                            # LayeredPattern built with padded planes
    mask,
    g,
    w0,
    group=None,
    device=None,
    pc: str = "jacobi",
    mg_levels: int = 3,
    dtype=None,
    **tols,
) -> NewtonResult:
    """Plane-sharded Newton solve on the layered operator with
    slab-partitioned element work (each rank assembles only its ~nc/D
    cells; one-plane halo).  Call it on every rank of ``group`` (None:
    the default group, or a single process when none is initialised) with
    the same host inputs; ``NewtonResult.x`` is this rank's slab
    (``gather_dofs`` joins the slabs).

    pc='mg' preconditions with the aggregation V-cycle (Chebyshev-Jacobi
    smoothing, the single-process ``mg_cheby``): level 0 plane-sharded,
    the coarse levels and the dense coarse inverse the same on every rank.

    ``lp.n_planes`` must be a multiple of the rank count (use
    build_layered(space, n2d, padded_planes(Lp, D)) + pad_mask_g).  Runs
    on the card unless ``device`` says otherwise.
    """
    device = comm.device_of(device)
    D, r = comm.world_size(group), comm.rank(group)
    arrays, slab, meta, (mask_s, g_s, w0_s) = shard_layered_inputs(
        lp, mask, g, w0, group, device, dtype)
    n2d, bs, E, Lq = lp.n2d, lp.bs, lp.E, meta["Lq"]
    nb = n2d * bs
    residual_fn, values_fn = make_slab_assembly(kernel, n2d, Lq, bs, E,
                                                group)
    # the neighbours' mask planes, once: the SpMV's halo columns and the
    # Galerkin product's column projection read them
    mask_ext = halo_extend(mask_s, nb, group)

    def reduce(t):
        return comm.all_reduce_sum(t, group)

    def residual(w):
        return mask_s * residual_fn(slab, w) + (1.0 - mask_s) * (w - g_s)

    def jac_values(w):
        return values_fn(slab, w)

    def operand(values, vdtype=None):
        return SlabOperand(values, arrays.cols, arrays.row_ptr, n2d,
                           mask_ext, group, vdtype)

    if pc == "mg":
        from ..solve.mg import SlabFine, make_mg_pc

        hier = _slab_hierarchy(lp, mask, mg_levels, Lq, r, device)

        def project(values):
            return project_values(
                _halo_values(values), mask_ext.to(values.dtype),
                arrays.cols, arrays.row_ids, n2d, Lq + 2)[..., 1:Lq + 1]

        fine = SlabFine(operand=operand, project=project, reduce=reduce)

        def make_pc(values):
            return make_mg_pc(hier, values, arrays.cols, arrays.row_ids,
                              arrays.row_ptr, arrays.diag_pos, mask_s, n2d,
                              Lq, smoother="cheby", fine=fine)
    elif pc == "jacobi":
        def make_pc(values):
            return block_jacobi(layered_diag_blocks(arrays, n2d, values),
                                mask_s)
    else:
        raise ValueError(f"pc={pc!r}: expected 'jacobi' or 'mg'")

    return newton_solve(residual, jac_values, operand, make_pc, w0_s,
                        reduce=reduce if D > 1 else None, **tols)


def gather_dofs(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """The whole (padded) dof vector from the ranks' slabs, on every
    rank."""
    return comm.all_gather_cat(x_local, group)
