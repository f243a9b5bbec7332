"""Structured-extrusion assembly: the scatter-free residual and Jacobian.

Counterpart of the JAX package's ``assemble/structured.py``.  The extruded
channel's cells form an (layer l, column c) grid where a column is a
(triangle, tet-of-prism) pair of the 2D cross-section, and the
(matrix-pair, plane-offset) scatter pattern of a column is LAYER-INVARIANT
(the Dompierre split depends only on relative node order, which the
plane-major numbering preserves).  So per 2D pair p the assembled values
across ALL planes are a fixed small set of per-column contribution
streams:

    V[ci, cj, p, l] = sum_t  J[col_t, l - off_t, a_t*bs+ci, b_t*bs+cj]

With the element Jacobians laid out as (column*entry, layer) — layer
minor — the reduction is row gathers plus plane-shifted adds: no
scatter.  The plan is derived from ``ell_pos`` and verified cell by cell
at build time (layer invariance is checked, not assumed).

The host plan (``build_structured_plan``) is numpy up to its final
upload.  On a CUDA tensor the SoA element forms of every cell are K4
(``soa_element.py``, ``csrc/soa_element.cu``): one launch writes the
Jacobian's or the residual's whole layer-minor buffer.  Their plain twin
(``gather_wT`` and the kernel's ``jac_soa`` / ``res_soa`` in Python loops
over the ``chunk_cells``-sized column chunks the JAX package scanned over)
serves CPU tensors.  The reductions (``_reduce_jac_buffer``, the
residual's ``_plane_shift_sum``) are plain PyTorch on either device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import upload
from . import soa_element
from .assembly import ASM_CHUNK, _cell_jacobians


@dataclasses.dataclass
class StructuredAsm:
    """Device tensors of the structured plan (rides inside
    ``LayeredArrays.sasm``); index tables are int64."""

    cell_dofs: torch.Tensor     # (M3p*nl, ndl) column-major (col, l) cells
    cell_coords: torch.Tensor   # (M3p*nl, nv, 3)
    alive: torch.Tensor         # (M3p*nl,) f32 1=real cell, 0=dead
    tab: torch.Tensor           # (3Ep, degA) row-base ids into the buffer
    off: torch.Tensor           # (3Ep, degA) f32 plane offset (0/1)
    tab_over: torch.Tensor      # (n_over, degB) row-base ids
    off_over: torch.Tensor      # (n_over, degB) f32
    over_ids: torch.Tensor      # (n_over,) pair ids
    coordsT: torch.Tensor       # (12, M3p*nl) transposed coords
    wdof: torch.Tensor          # (M3p, ndl) 2D scalar dof (row of w2)
    wolay: torch.Tensor         # (M3p, ndl) plane offset {0,1}
    rtab: torch.Tensor          # (n2d*bs, degR) rows col*ndl+a
    roff: torch.Tensor          # (n2d*bs, degR) f32 plane offset
    rtab_over: torch.Tensor     # (n_rover, degRB)
    roff_over: torch.Tensor     # (n_rover, degRB) f32
    rover_ids: torch.Tensor     # (n_rover,) target scalar-dof ids
    # (M3p*nl,) row of the padded cell table each structured cell takes
    # its coordinates from (``layered.layered_arrays_in``); None in a plan
    # converted from the JAX package's, which has no such field
    cell_ids: Optional[torch.Tensor] = None
    # cells of one call of the plain SoA twin (``_chunks``): M3p is padded
    # to whole chunks of max(1, chunk_cells // nl) columns (K4 takes the
    # whole mesh at once)
    chunk_cells: int = ASM_CHUNK

    @classmethod
    def from_numpy(cls, fields: Mapping, device) -> "StructuredAsm":
        """Upload host fields (by name) to ``device``."""
        return cls(**{f.name: upload(fields[f.name], device)
                      for f in dataclasses.fields(cls) if f.name in fields})


def build_structured_plan(mesh, cd_np, cc_np, ep_np, n2d: int, Lp: int,
                          E: int, bs: int, device=None,
                          max_degA: int = 8,
                          cover: float = 0.99,
                          chunk_cells: int = ASM_CHUNK
                          ) -> Optional[StructuredAsm]:
    """Host-side plan build from the (numpy) padded cell arrays, uploaded
    to ``device`` at the end; returns None when the mesh does not carry
    the extrusion grid or the pattern fails layer-invariance.
    ``chunk_cells``: the cells the SoA kernels take in one call."""
    ext = getattr(mesh, "extrusion", None)
    if ext is None:
        return None
    ntri, nl, keep = ext            # keep: (nl, ntri) bool
    if nl != Lp - 1:
        return None
    nbl = ep_np.shape[1]
    ndl = cd_np.shape[1]
    nc = mesh.n_cells
    cells = np.asarray(mesh.cells[:nc])
    ep = np.asarray(ep_np)[:nc]                   # (nc, nbl, nbl)
    cd = np.asarray(cd_np)[:nc]
    cc = np.asarray(cc_np)[:nc]
    M3 = 3 * ntri

    # ---- cell grid from the deterministic extrusion order -------------
    k_l = keep.sum(axis=1) * 3
    if int(k_l.sum()) != nc:
        return None
    offs = np.concatenate([[0], np.cumsum(k_l)])
    grid = np.full((nl, M3), -1, np.int64)
    for l in range(nl):
        kept = np.nonzero(keep[l])[0]
        cols = (3 * kept[:, None] + np.arange(3)[None, :]).ravel()
        grid[l, cols] = offs[l] + np.arange(len(cols))

    # ---- derive (pair, off) per cell and verify layer-invariance ------
    lb = (cells.min(axis=1) // n2d).astype(np.int64)       # base plane
    pair = ep // Lp                                        # (nc, nbl, nbl)
    off = ep % Lp - lb[:, None, None]
    if off.min() < 0 or off.max() > 1:
        return None
    alive = grid >= 0
    gi = np.where(alive, grid, 0)
    # reference = first alive layer of each column
    first_l = np.argmax(alive, axis=0)                     # (M3,)
    ref_cell = gi[first_l, np.arange(M3)]
    pref, oref = pair[ref_cell], off[ref_cell]             # (M3, nbl, nbl)
    ok = ((pair[gi] == pref[None]) & (off[gi] == oref[None])) \
        | ~alive[:, :, None, None]
    if not bool(ok.all()):
        return None
    if not bool((lb[gi] == np.arange(nl)[:, None])[alive].all()):
        return None

    # ---- invert: pair p -> padded contribution tables -----------------
    # contribution q = col*nbl*nbl + a*nbl + b; buffer row base =
    # col*ndl*ndl + a*bs*ndl + b*bs (16 (ci, cj) rows at +ci*ndl+cj)
    n_pairs = 3 * E
    q = np.arange(M3 * nbl * nbl, dtype=np.int64)
    colq, aq, bq = q // (nbl * nbl), (q // nbl) % nbl, q % nbl
    rowbase = colq * ndl * ndl + aq * bs * ndl + bq * bs
    p_flat = pref.reshape(-1).astype(np.int64)
    o_flat = oref.reshape(-1)
    order = np.argsort(p_flat, kind="stable")
    counts = np.bincount(p_flat, minlength=n_pairs)
    starts = np.zeros(n_pairs + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    degA = int(min(max(np.quantile(counts, cover), 1), max_degA))
    trash_row = M3 * ndl * ndl                  # the appended zero block
    j = np.arange(degA, dtype=np.int64)
    idxA = starts[:n_pairs, None] + j[None, :]
    valid = j[None, :] < counts[:, None]
    src = order[np.minimum(idxA, M3 * nbl * nbl - 1)]
    tab = np.where(valid, rowbase[src], trash_row).astype(np.int32)
    offA = np.where(valid, o_flat[src], 0).astype(np.float32)
    over_ids = np.nonzero(counts > degA)[0]
    if len(over_ids):
        degB = int(counts[over_ids].max()) - degA
        jB = degA + np.arange(degB, dtype=np.int64)
        idxB = starts[over_ids, None] + jB[None, :]
        validB = jB[None, :] < counts[over_ids, None]
        srcB = order[np.minimum(idxB, M3 * nbl * nbl - 1)]
        tab_over = np.where(validB, rowbase[srcB], trash_row) \
            .astype(np.int32)
        off_over = np.where(validB, o_flat[srcB], 0).astype(np.float32)
    else:
        tab_over = np.full((0, 1), trash_row, np.int32)
        off_over = np.zeros((0, 1), np.float32)

    # ---- pad: columns to a chunk multiple, pairs to a multiple of 8 ---
    m = max(1, chunk_cells // nl)
    M3p = -(-M3 // m) * m
    P = 8
    n_pp = -(-n_pairs // P) * P
    if n_pp > n_pairs:
        padt = np.full((n_pp - n_pairs, tab.shape[1]), trash_row, np.int32)
        tab = np.concatenate([tab, padt])
        offA = np.concatenate(
            [offA, np.zeros((n_pp - n_pairs, offA.shape[1]), np.float32)])

    # ---- column-major structured cell arrays --------------------------
    ndofs = n2d * Lp * bs
    giT = grid.T                                   # (M3, nl)
    aliveT = alive.T
    gsafe = np.where(aliveT, giT, 0)
    scd = np.empty((M3p, nl, ndl), np.int32)
    scd[:M3] = cd[gsafe]
    scd[:M3][~aliveT] = ndofs                      # dead cells: safe dof
    scd[M3:] = ndofs
    np_dtype = cc.dtype
    scc = np.empty((M3p, nl) + cc.shape[1:], np_dtype)
    scc[:M3] = cc[gsafe]
    scc[M3:] = cc[0]
    smask = np.zeros((M3p, nl), np.float32)
    smask[:M3] = aliveT
    cell_ids = np.zeros((M3p, nl), np.int64)
    cell_ids[:M3] = gsafe

    # ---- SoA extension: transposed coords + w-gather + residual plan --
    soa_fields = _build_soa_tables(
        cd, gi, alive, first_l, lb, scc, n2d, bs, nl, M3, M3p, ndl)

    if not soa_fields:
        return None
    return dataclasses.replace(StructuredAsm.from_numpy(dict(
        cell_dofs=scd.reshape(M3p * nl, ndl),
        cell_coords=scc.reshape((M3p * nl,) + cc.shape[1:]),
        alive=smask.reshape(M3p * nl),
        tab=tab,
        off=offA,
        tab_over=tab_over,
        off_over=off_over,
        over_ids=over_ids.astype(np.int32),
        cell_ids=cell_ids.reshape(M3p * nl),
        **soa_fields,
    ), device), chunk_cells=chunk_cells)


def _build_soa_tables(cd, gi, alive, first_l, lb, scc, n2d, bs, nl, M3,
                      M3p, ndl):
    """Host-side tables for the SoA assembly path.

    Derives the layer-invariant (2D scalar dof, plane offset) of every
    (column, local dof) from the reference layer, VERIFIES it against
    every alive cell's dofmap, and inverts it into the residual
    reduction tables.  Returns {} when the invariance fails.
    """
    if ndl != 16 or bs != 4:
        return {}
    n2dbs = n2d * bs
    ref_cell = gi[first_l, np.arange(M3)]
    cdr = cd[ref_cell].astype(np.int64)              # (M3, ndl)
    lbr = lb[ref_cell][:, None]
    oa = cdr // n2dbs - lbr                          # (M3, ndl)
    if oa.min() < 0 or oa.max() > 1:
        return {}
    n2da = cdr % n2dbs
    # verify: dof(col, a, l) == (l + oa)*n2dbs + n2da for every alive cell
    expect = ((np.arange(nl)[:, None, None] + oa[None]) * n2dbs
              + n2da[None])                          # (nl, M3, ndl)
    ok = (cd[np.where(alive, gi, 0)] == expect) | ~alive[:, :, None]
    if not bool(ok.all()):
        return {}

    # w-gather tables, padded columns -> row 0 (dead, masked)
    wdof = np.zeros((M3p, ndl), np.int32)
    wdof[:M3] = n2da
    wolay = np.zeros((M3p, ndl), np.int32)
    wolay[:M3] = oa

    # residual reduction: target scalar dof t = n2da, source row
    # col*ndl + a of the (M3p*ndl, nl) contribution buffer, shifted by oa
    t_flat = n2da.reshape(-1)
    src = (np.arange(M3, dtype=np.int64)[:, None] * ndl
           + np.arange(ndl)[None, :]).reshape(-1)
    o_flat = oa.reshape(-1)
    order = np.argsort(t_flat, kind="stable")
    counts = np.bincount(t_flat, minlength=n2dbs)
    starts = np.zeros(n2dbs + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    degR = int(min(max(np.quantile(counts, 0.99), 1), 40))
    trash = M3p * ndl                                # appended zero row
    j = np.arange(degR, dtype=np.int64)
    idx = starts[:n2dbs, None] + j[None, :]
    valid = j[None, :] < counts[:, None]
    pick = order[np.minimum(idx, M3 * ndl - 1)]
    rtab = np.where(valid, src[pick], trash).astype(np.int32)
    roff = np.where(valid, o_flat[pick], 0).astype(np.float32)
    rover_ids = np.nonzero(counts > degR)[0]
    if len(rover_ids):
        degB = int(counts[rover_ids].max()) - degR
        jB = degR + np.arange(degB, dtype=np.int64)
        idxB = starts[rover_ids, None] + jB[None, :]
        validB = jB[None, :] < counts[rover_ids, None]
        pickB = order[np.minimum(idxB, M3 * ndl - 1)]
        rtab_over = np.where(validB, src[pickB], trash).astype(np.int32)
        roff_over = np.where(validB, o_flat[pickB], 0).astype(np.float32)
    else:
        rtab_over = np.full((0, 1), trash, np.int32)
        roff_over = np.zeros((0, 1), np.float32)

    coordsT = np.ascontiguousarray(
        scc.reshape(M3p * nl, -1).T)                 # (12, M3p*nl)
    return dict(
        coordsT=coordsT,
        wdof=wdof,
        wolay=wolay,
        rtab=rtab,
        roff=roff,
        rtab_over=rtab_over,
        roff_over=roff_over,
        rover_ids=rover_ids.astype(np.int32),
    )


def gather_wT(sasm: StructuredAsm, Lp: int, w: torch.Tensor) -> torch.Tensor:
    """(ndl, M3p*nl) transposed solution gather: per (column, local dof)
    the dof ids across layers are an arithmetic sequence, so the gather
    moves nl-long plane rows of w2 = w reshaped (n2d*bs, Lp)."""
    nl = Lp - 1
    M3p, ndl = sasm.wdof.shape
    w2 = w.reshape(Lp, -1)                            # (Lp, n2dbs)
    lidx = sasm.wolay.reshape(-1, 1) + torch.arange(
        nl, device=w.device)                          # (M3p*ndl, nl)
    rows = w2[lidx, sasm.wdof.reshape(-1, 1)]         # (M3p*ndl, nl)
    return rows.reshape(M3p, ndl, nl).permute(1, 0, 2).reshape(ndl, M3p * nl)


def _chunks(M3p: int, nl: int, chunk_cells: int):
    """Column chunks of ``chunk_cells`` cells (the plan's): yields (chunk
    index, first cell, columns per chunk)."""
    m = max(1, chunk_cells // nl)
    for k in range(M3p // m):
        yield k, k * m * nl, m


def _jac_buffer_plain(kernel, Lp: int, sasm: StructuredAsm,
                      w: torch.Tensor) -> torch.Tensor:
    """K4's twin: the (M3p*256, nl) layer-minor element Jacobians from
    the kernel's ``jac_soa`` (forms/soa.py), chunk by chunk, on the
    plane-sliced w-gather."""
    nl = Lp - 1
    ndl = sasm.wdof.shape[1]
    e2 = ndl * ndl
    M3p = sasm.coordsT.shape[1] // nl
    wT = gather_wT(sasm, Lp, w)
    alive = sasm.alive.to(w.dtype)
    buf = w.new_empty((M3p * e2, nl))
    for k, c0, m in _chunks(M3p, nl, sasm.chunk_cells):
        sl = slice(c0, c0 + m * nl)
        J = kernel.jac_soa(sasm.coordsT[:, sl], wT[:, sl]) * alive[sl]
        buf[k * m * e2:(k + 1) * m * e2] = \
            J.reshape(e2, m, nl).permute(1, 0, 2).reshape(m * e2, nl)
    return buf


def _res_buffer_plain(kernel, Lp: int, sasm: StructuredAsm,
                      w: torch.Tensor) -> torch.Tensor:
    """K4's twin: the (M3p*ndl + 1, nl) layer-minor element residuals
    (the last row zero) from the kernel's ``res_soa``, chunk by chunk."""
    nl = Lp - 1
    M3p, ndl = sasm.wdof.shape
    wT = gather_wT(sasm, Lp, w)
    alive = sasm.alive.to(w.dtype)
    rbufz = w.new_zeros((M3p * ndl + 1, nl))          # + appended zero row
    for k, c0, m in _chunks(M3p, nl, sasm.chunk_cells):
        sl = slice(c0, c0 + m * nl)
        r = kernel.res_soa(sasm.coordsT[:, sl], wT[:, sl]) * alive[sl]
        rbufz[k * m * ndl:(k + 1) * m * ndl] = \
            r.reshape(ndl, m, nl).permute(1, 0, 2).reshape(m * ndl, nl)
    return rbufz


def matrix_values_structured_soa(kernel, E: int, Lp: int, bs: int,
                                 sasm: StructuredAsm,
                                 w: torch.Tensor) -> torch.Tensor:
    """(bs, bs, 3, E, Lp) Jacobian values via the SoA element forms: K4
    on a CUDA tensor (one launch), the plain twin on a CPU tensor."""
    if w.is_cuda:
        buf = soa_element.jacobian(kernel, sasm, Lp, w)
    else:
        buf = _jac_buffer_plain(kernel, Lp, sasm, w)
    return _reduce_jac_buffer(buf, sasm, E, Lp, bs, sasm.wdof.shape[1],
                              Lp - 1, w.dtype)


def _plane_shift_sum(rows, o):
    """sum over axis 1 of rows landing on plane l (o = 0) and l + 1
    (o = 1): (n, deg, ..., nl) -> (n, ..., nl + 1)."""
    s0 = (rows * (1.0 - o)).sum(dim=1)
    s1 = (rows * o).sum(dim=1)
    return F.pad(s0, (0, 1)) + F.pad(s1, (1, 0))


def residual_structured(kernel, Lp: int, sasm: StructuredAsm,
                        w: torch.Tensor) -> torch.Tensor:
    """(ndofs,) global residual via the SoA element forms (K4 on a CUDA
    tensor, the plain twin on a CPU tensor) + the structured reduction:
    contributions land as (col*ndl + a, layer) rows and reduce per 2D
    scalar dof with plane-shifted row gathers."""
    if w.is_cuda:
        rbufz = soa_element.residual(kernel, sasm, Lp, w)
    else:
        rbufz = _res_buffer_plain(kernel, Lp, sasm, w)

    def reduce(tab, off):
        return _plane_shift_sum(rbufz[tab], off[:, :, None].to(w.dtype))

    R2 = reduce(sasm.rtab, sasm.roff)                 # (n2d*bs, Lp)
    if sasm.rtab_over.shape[0] > 0:
        R2.index_add_(0, sasm.rover_ids,
                      reduce(sasm.rtab_over, sasm.roff_over))
    return R2.T.reshape(-1)                           # (Lp*n2d*bs,)


def matrix_values_structured(kernel, E: int, Lp: int, bs: int,
                             sasm: StructuredAsm,
                             w: torch.Tensor) -> torch.Tensor:
    """(bs, bs, 3, E, Lp) Jacobian values via the structured plan: the SoA
    kernel when the element kernel has one, else per-cell Jacobians
    (analytic or jacfwd) in the same layer-minor buffer."""
    if kernel.jac_soa is not None:
        return matrix_values_structured_soa(kernel, E, Lp, bs, sasm, w)
    nl = Lp - 1
    ndl = sasm.cell_dofs.shape[1]
    e2 = ndl * ndl
    M3p = sasm.cell_dofs.shape[0] // nl
    buf = w.new_empty((M3p * e2, nl))
    for k, c0, m in _chunks(M3p, nl, sasm.chunk_cells):
        sl = slice(c0, c0 + m * nl)
        J = _cell_jacobians(kernel, sasm.cell_coords[sl],
                            sasm.cell_dofs[sl], w)
        J = J * sasm.alive[sl].to(w.dtype)[:, None, None]
        buf[k * m * e2:(k + 1) * m * e2] = \
            J.reshape(m, nl, e2).permute(0, 2, 1).reshape(m * e2, nl)
    return _reduce_jac_buffer(buf, sasm, E, Lp, bs, ndl, nl, w.dtype)


def _reduce_jac_buffer(buf, sasm: StructuredAsm, E: int, Lp: int,
                       bs: int, ndl: int, nl: int, dtype) -> torch.Tensor:
    """(M3p*e2, nl) layer-minor contribution rows -> (bs, bs, 3, E, Lp)
    via the pair tables (shared by the AoS and SoA buffer builders)."""
    e2 = ndl * ndl
    bufz = torch.cat([buf, buf.new_zeros((e2, nl))])
    b2 = bs * bs
    ar = torch.arange(bs, device=buf.device)
    ent = (ar[:, None] * ndl + ar[None, :]).reshape(-1)   # ci*ndl + cj

    def reduce_pairs(tab, off):
        np_, deg = tab.shape
        idx = tab[:, :, None] + ent[None, None, :]
        rows = bufz[idx.reshape(-1)].reshape(np_, deg, b2, nl)
        return _plane_shift_sum(rows, off[:, :, None, None].to(dtype))

    # 8 pair slices bound the gathered-rows temporary
    n_pp = sasm.tab.shape[0]
    P = 8
    cE = n_pp // P
    V = torch.cat([reduce_pairs(sasm.tab[k * cE:(k + 1) * cE],
                                sasm.off[k * cE:(k + 1) * cE])
                   for k in range(P)], dim=0)[:3 * E]     # (3E, b2, Lp)
    if sasm.tab_over.shape[0] > 0:
        V.index_add_(0, sasm.over_ids,
                     reduce_pairs(sasm.tab_over, sasm.off_over))
    return V.permute(1, 0, 2).reshape(bs, bs, 3, E, Lp).contiguous()
