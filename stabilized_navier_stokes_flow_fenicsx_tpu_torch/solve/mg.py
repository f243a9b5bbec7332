"""Aggregation multigrid on the layered operator.

Counterpart of the JAX package's ``solve/mg.py``: its smoothers (plane
Gauss-Seidel by default, Jacobi, Chebyshev, zebra, the line solves,
grouped plane-GS), the V- and W-cycle, and the dense or relaxed coarse
solve.  The layered operator is (2D cross-section graph) x (tridiagonal
plane coupling), and that tensor structure survives coarsening:

* 2D: greedy graph aggregation (aggregates of ~4 nodes) — piecewise-
  constant prolongation over node blocks, so the (bs, bs) u/p block
  structure is preserved on every level;
* planes: pair planes l -> l//2 — tridiagonal stays tridiagonal.

With 0/1 prolongation the Galerkin product RAP is a segment-sum
(``index_add_``) of the fine value tensor with a host-precomputed index
map.  Dirichlet handling: the fine values are projected (P A P) before
RAP, the coarse mask marks an aggregate component free iff any member is
free, and every level's operator acts as P A P + (I - P).

Precision: the V-cycle's value tensors may be stored in ``pc_dtype``
(bf16 on the Newton path).  The Jacobi-family smoothers and their
spectral estimate run in float32 (mask, iterate and accumulation); the
plane-GS sweep in float32 with bf16 values and float64 with float64 ones
(solve/plane_gs.py); the cycle's residuals stay in the caller's dtype;
the coarsest level is inverted densely in float32 and polished by two
Newton-Schulz steps.  Every level matvec is kernel K1
(assemble/layered_spmv.py) on the card, with the level's BC projection
fused in, and every plane-GS sweep kernel K2 (csrc/plane_gs.cu).

Under ranks (parallel/layered_shard.py) level 0 is plane-sharded and the
coarse levels are replicated: ``SlabFine`` carries what differs there.
Each rank forms its part of the first Galerkin product from its slab of
values through its slice of ``seg_map`` and the parts are summed over the
ranks; each rank restricts its rows through its slice of ``node_map`` and
the coarse residual is summed; prolongation reads the slice.  The result
is the single-process V-cycle up to summation order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..assemble.layered_spmv import LayeredOperand, project_values
from ..utils.device import row_ptr_of, upload
from .krylov import _norm_t
from .precond import block_jacobi

DENSE_CAP = 8192   # most dofs of a coarsest level the dense solve inverts
AGG_TARGET = 4     # 2D nodes per aggregate
MIN_DOFS = 2000    # no level is coarsened once it has this many dofs or fewer
CHEBY_ALPHA = 3.0  # the smoother damps [lmax / alpha, lmax]
CHEBY_SAFETY = 1.4  # lmax = safety * the spectral estimate


@dataclasses.dataclass
class MGLevel:
    """Device tensors for one coarse level.

    seg_map/node_map live on the PARENT (finer) level's index space and
    define restriction into this level.
    """

    seg_map: torch.Tensor     # (3*E_f*Lp_f,) -> coarse seg id or trash
    node_map: torch.Tensor    # (Lp_f*n2d_f,) -> coarse node id
    cols: torch.Tensor        # (E_c,)
    row_ids: torch.Tensor     # (E_c,) sorted
    row_ptr: torch.Tensor     # (n2d_c + 1,)
    diag_pos: torch.Tensor    # (n2d_c,)
    mask: torch.Tensor        # (Lp_c*n2d_c*bs,)

    @classmethod
    def from_numpy(cls, fields: Mapping, device) -> "MGLevel":
        """Upload host fields (by name); ``row_ptr`` is derived from the
        sorted ``row_ids`` when absent."""
        row_ptr = fields.get("row_ptr")
        if row_ptr is None:
            row_ptr = row_ptr_of(fields["row_ids"], len(fields["diag_pos"]))
        names = ("seg_map", "node_map", "cols", "row_ids", "diag_pos",
                 "mask")
        return cls(row_ptr=upload(row_ptr, device),
                   **{k: upload(fields[k], device) for k in names})


@dataclasses.dataclass
class MGHierarchy:
    levels: Tuple[MGLevel, ...]
    dims: Tuple[Tuple[int, int, int], ...]      # (n2d, Lp, E) per level


@dataclasses.dataclass
class SlabFine:
    """Level 0 of a plane-sharded V-cycle.  The hierarchy's level-0
    ``seg_map`` and ``node_map`` are then this rank's slices, and the
    values, mask and plane count given to ``make_mg_pc`` its slab's."""

    operand: Callable   # (values, dtype) -> the slab's x -> A x (halo
                        # exchange inside), with ``masks`` as K1's operand
    project: Callable   # values -> P A P on the slab, columns by the
                        # neighbours' mask planes at its two ends
    reduce: Callable    # tensor -> its sum over the ranks


def _aggregate_graph(rows: np.ndarray, cols: np.ndarray,
                     n: int) -> Tuple[np.ndarray, int]:
    """Greedy BFS aggregation of an undirected graph into clusters of up
    to ``AGG_TARGET`` nodes.  Returns (agg id per node, n_agg)."""
    order = np.argsort(rows, kind="stable")
    r_s, c_s = rows[order], cols[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, r_s + 1, 1)
    indptr = np.cumsum(indptr)
    agg = np.full(n, -1, np.int64)
    n_agg = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        agg[i] = n_agg
        size = 1
        for j in c_s[indptr[i]:indptr[i + 1]]:
            if size >= AGG_TARGET:
                break
            if agg[j] < 0:
                agg[j] = n_agg
                size += 1
        n_agg += 1
    return agg, n_agg


def _coarsen_level(
    rows2d: np.ndarray, cols2d: np.ndarray, n2d: int, Lp: int,
    mask_np: np.ndarray, bs: int,
):
    """Host-side maps for one coarsening step (2D aggregation, planes
    paired l -> l // 2)."""
    E = len(rows2d)
    agg, n2d_c = _aggregate_graph(rows2d, cols2d, n2d)
    Lp_c = (Lp + 1) // 2

    # coarse 2D pairs = image of fine pairs (plus plane-offset pairs map
    # onto the same 2D pair set)
    ck = agg[rows2d] * n2d_c + agg[cols2d]
    uniq, pair_of_fine = np.unique(ck, return_inverse=True)
    E_c = len(uniq)
    rows2d_c = (uniq // n2d_c).astype(np.int32)
    cols2d_c = (uniq % n2d_c).astype(np.int32)
    diag_keys = np.arange(n2d_c, dtype=np.int64) * (n2d_c + 1)
    diag_pos_c = np.searchsorted(uniq, diag_keys)
    if not (uniq[diag_pos_c] == diag_keys).all():
        raise ValueError("coarse level lost a diagonal pair")

    # seg map on the fine (d, e, l) grid: seg = (d*E + e)*Lp + l
    d_grid = np.arange(3)[:, None, None] - 1           # -1, 0, +1
    e_grid = np.arange(E)[None, :, None]
    l_grid = np.arange(Lp)[None, None, :]
    lcol = l_grid + d_grid
    valid = (lcol >= 0) & (lcol < Lp)
    L = l_grid // 2
    Lcol = np.where(valid, lcol, 0) // 2
    d_c = Lcol - L
    valid &= (d_c >= -1) & (d_c <= 1)
    e_c = pair_of_fine[e_grid]
    seg_c = ((d_c + 1) * E_c + e_c) * Lp_c + L
    n_seg_c = 3 * E_c * Lp_c
    seg_map = np.where(valid, seg_c, n_seg_c).reshape(-1).astype(np.int32)

    # node map (plane-major): fine (l, i) -> coarse (l//2, agg[i])
    l_f = np.repeat(np.arange(Lp), n2d)
    i_f = np.tile(np.arange(n2d), Lp)
    node_map = (l_f // 2 * n2d_c + agg[i_f]).astype(np.int32)

    # coarse mask: free iff any member free
    mb = mask_np.reshape(Lp * n2d, bs)
    mask_c = np.zeros((Lp_c * n2d_c, bs), mask_np.dtype)
    np.maximum.at(mask_c, node_map, mb)

    return (seg_map, node_map, rows2d_c, cols2d_c, diag_pos_c,
            mask_c.reshape(-1), n2d_c, Lp_c, E_c)


def build_mg_hierarchy(
    rows2d: np.ndarray, cols2d: np.ndarray, n2d: int, Lp: int,
    mask_np: np.ndarray, bs: int,
    n_levels: int = 3, device=None,
) -> MGHierarchy:
    """Host-side setup: ``n_levels`` coarsenings (or until a level has
    ``MIN_DOFS`` dofs or fewer), uploaded to ``device``.  Static per
    mesh; values are re-RAP'd per Newton iteration on the device."""
    levels: List[MGLevel] = []
    dims: List[Tuple[int, int, int]] = []
    r, c, n, L, m = (np.asarray(rows2d, np.int64), np.asarray(cols2d, np.int64),
                     int(n2d), int(Lp), np.asarray(mask_np))
    for _ in range(n_levels):
        if n * L * bs <= MIN_DOFS:
            break
        (seg_map, node_map, r_c, c_c, dp_c, m_c, n_c, L_c, E_c) = \
            _coarsen_level(r, c, n, L, m, bs)
        levels.append(MGLevel.from_numpy(dict(
            seg_map=seg_map, node_map=node_map, cols=c_c, row_ids=r_c,
            diag_pos=dp_c, mask=m_c), device))
        dims.append((n_c, L_c, E_c))
        r, c, n, L, m = r_c.astype(np.int64), c_c.astype(np.int64), \
            n_c, L_c, m_c
    return MGHierarchy(levels=tuple(levels), dims=tuple(dims))


def _lam_max_tail(Dinv, mv32, mk32, n_pow=12, burn_in=5, reduce=None):
    """|lambda|max(D^-1 A) estimate that is robust on the nonnormal NS
    Jacobian: power iteration with a running MAX of the norm ratios over
    the tail iterations (float32).

    Plain power iteration (the final ratio) underestimates at evolved NS
    states: the dominant eigenpair goes complex and the iterate norm
    oscillates over the rotating eigenplane, so the last sample can land
    well below |lambda|; the Chebyshev polynomial then amplifies the modes
    above its interval.  The tail max samples the oscillation peak, and
    leftover nonnormal transient growth biases it high — the safe
    direction.  ``reduce`` sums the squared norms over the ranks when the
    level is sharded.
    """
    v = mk32 / torch.clamp_min(_norm_t(mk32, reduce), 1e-30)
    best = torch.zeros((), dtype=torch.float32, device=mk32.device)
    for i in range(n_pow):
        w = Dinv(mv32(v))
        nw = torch.clamp_min(_norm_t(w, reduce), 1e-30)
        if i >= burn_in:
            best = torch.maximum(best, nw)
        v = w / nw
    return best


@dataclasses.dataclass
class LevelOperator:
    """One V-cycle level: its Galerkin values on its pair list (K1 reads
    ``cols`` and ``row_ptr``)."""

    values: torch.Tensor      # (bs, bs, 3, E, Lp); level 0 unprojected
    cols: torch.Tensor
    row_ids: torch.Tensor
    row_ptr: torch.Tensor
    diag_pos: torch.Tensor
    mask: torch.Tensor        # in values' dtype
    n2d: int
    n_planes: int


def galerkin_levels(
    hierarchy: MGHierarchy,
    values: torch.Tensor,         # fine (bs, bs, 3, E, Lp), unprojected
    cols: torch.Tensor,
    row_ids: torch.Tensor,
    row_ptr: torch.Tensor,
    diag_pos: torch.Tensor,
    mask: torch.Tensor,
    n2d: int,
    n_planes: int,
    fine: Optional[SlabFine] = None,
) -> List[LevelOperator]:
    """The fine level plus one RAP product per hierarchy level.

    Level 0 keeps the RAW value tensor (every V-cycle matvec is already
    mask-composed); projection happens transiently inside the RAP only.
    With ``fine`` the first product is this rank's part, summed over the
    ranks."""
    bs = values.shape[0]
    ops = [LevelOperator(values, cols, row_ids, row_ptr, diag_pos, mask,
                         n2d, n_planes)]
    for k, (lev, (n_c, L_c, E_c)) in enumerate(
            zip(hierarchy.levels, hierarchy.dims)):
        f = ops[-1]
        sharded = fine is not None and k == 0
        if sharded:
            Vf = fine.project(f.values)
        else:
            Vf = project_values(f.values, f.mask.to(values.dtype), f.cols,
                                f.row_ids, f.n2d, f.n_planes)
        n_seg_c = 3 * E_c * L_c
        Vc = Vf.new_zeros((bs * bs, n_seg_c + 1))
        Vc.index_add_(1, lev.seg_map, Vf.reshape(bs * bs, -1))
        if sharded:
            Vc = fine.reduce(Vc)
        Vc = Vc[:, :n_seg_c].reshape(bs, bs, 3, E_c, L_c)
        # re-project: aggregates can mix free/constrained dofs
        Vc = project_values(Vc, lev.mask.to(Vc.dtype), lev.cols,
                            lev.row_ids, n_c, L_c)
        ops.append(LevelOperator(Vc, lev.cols, lev.row_ids, lev.row_ptr,
                                 lev.diag_pos, lev.mask.to(Vc.dtype),
                                 n_c, L_c))
    return ops


def make_mg_pc(
    hierarchy: MGHierarchy,
    values: torch.Tensor,         # fine (bs, bs, 3, E, Lp), unprojected
    cols: torch.Tensor,
    row_ids: torch.Tensor,
    row_ptr: torch.Tensor,
    diag_pos: torch.Tensor,
    mask: torch.Tensor,
    n2d: int,
    n_planes: int,
    n_coarse_sweeps: int = 4,
    pc_dtype=None,
    smoother: str = "plane_gs",
    coarse: str = "dense",
    dense_cap: int = DENSE_CAP,
    cycle_type: str = "v",
    cheby_degree: int = 6,
    fine: Optional[SlabFine] = None,
) -> Callable:
    """V-cycle (``cycle_type="w"``: W-cycle) preconditioner closure
    r -> x for the layered operator.

    Smoothers (the JAX package's): 'plane_gs' (default; plane Gauss-Seidel,
    kernel K2 on the card), 'jacobi' (two damped node-block Jacobi sweeps,
    omega = 1.4 / (``CHEBY_SAFETY`` times the ``_lam_max_tail``
    estimate)), 'cheby' (a degree-q Chebyshev polynomial in D^-1 A over
    node-block Jacobi, damping [lmax/alpha, lmax] with lmax the
    ``_lam_max_tail`` estimate times ``CHEBY_SAFETY``; fixed once built, so
    a linear operator), 'zebra' (red-black planes, one sweep), 'line' /
    'lined' (the vertical-line solve by cyclic reduction, undamped / damped
    0.7), 'linej' (the line solve then a damped node-block Jacobi pass),
    'grouped' (plane-GS over groups of 8 planes).  ``CHEBY_ALPHA`` and
    ``CHEBY_SAFETY`` are constants: the JAX package's ``SNS_CHEBY_*``
    environment overrides are not ported.

    coarse='dense': the coarsest level is solved exactly by a dense
    float32 inverse when it has at most ``dense_cap`` dofs; otherwise (or
    with any other ``coarse``) it is relaxed with its smoother,
    ``n_coarse_sweeps`` times.  ``fine``: level 0 is this rank's slab
    (``SlabFine``); the levels below it and the coarse solve are the same
    on every rank; it takes the 'cheby' V-cycle only, as the JAX
    package's sharded path uses."""
    from .precond import (line_cr_layered, plane_gs_grouped,
                          plane_gs_layered, plane_zebra_layered)

    bs = values.shape[0]
    f32 = torch.float32
    if fine is not None and (smoother != "cheby" or cycle_type != "v"):
        raise ValueError(f"a plane-sharded V-cycle takes smoother='cheby' "
                         f"and cycle_type='v', not {smoother!r} and "
                         f"{cycle_type!r}")
    ops = galerkin_levels(hierarchy, values, cols, row_ids, row_ptr,
                          diag_pos, mask, n2d, n_planes, fine)
    top = ops[-1]
    if fine is not None and len(ops) == 1:
        raise ValueError("a plane-sharded V-cycle needs a coarse level")
    coarse_apply = None
    if coarse == "dense" and top.n2d * top.n_planes * bs <= dense_cap:
        coarse_apply = _dense_coarse_inverse(top)

    smoothers = []
    matvecs = []
    for k, op in enumerate(ops):
        # K1's operand: the V-cycle streams its values in pc_dtype (half
        # the bytes in bf16; the cast rides the layout copy), masked; it
        # serves f64 residuals and the f32 Jacobi-family smoothers alike
        sharded = fine is not None and k == 0
        if sharded:
            mv = fine.operand(op.values, pc_dtype)
        else:
            mv = LayeredOperand(op.values, op.cols, op.row_ptr, op.n2d,
                                mask=op.mask, dtype=pc_dtype)
        matvecs.append(mv)
        # the smoothers' values: the level's in pc_dtype, as the JAX
        # package casts them before building its smoothers
        Vk = op.values if pc_dtype is None else op.values.to(pc_dtype)
        args = (Vk, op.cols, op.row_ids, op.diag_pos, op.mask, op.n2d,
                op.n_planes)

        mk32 = mv.masks[f32]
        if smoother in ("jacobi", "cheby"):
            Dinv = _node_jacobi32(Vk, op.diag_pos, mk32)
            ub = CHEBY_SAFETY * torch.clamp_min(
                _lam_max_tail(Dinv, mv, mk32,
                              reduce=fine.reduce if sharded else None), 1e-6)
            if smoother == "jacobi":
                # omega scaled to the measured spectrum: 1.4 / ub is the
                # classical 0.7 at benign states (ub ~ 2) and stays stable
                # where the spectrum reaches further
                sm = functools.partial(_jacobi_sweeps, Dinv, mv, 1.4 / ub)
            else:
                sm = functools.partial(_chebyshev, Dinv, mv, ub,
                                       cheby_degree)
        elif smoother == "zebra":
            sm = plane_zebra_layered(*args, zebra_sweeps=1,
                                     pc_dtype=pc_dtype)
        elif smoother == "linej":
            # the line solve owns the streamwise coupling, the Jacobi
            # pass damps the in-plane modes it ignores
            base = line_cr_layered(Vk, op.diag_pos, op.mask, op.n2d,
                                   op.n_planes, pc_dtype=pc_dtype)
            sm = functools.partial(_line_jacobi, base,
                                   _node_jacobi32(Vk, op.diag_pos, mk32),
                                   mv, 0.7)
        elif smoother in ("line", "lined"):
            base = line_cr_layered(Vk, op.diag_pos, op.mask, op.n2d,
                                   op.n_planes, pc_dtype=pc_dtype)
            sm = base if smoother == "line" else \
                functools.partial(_damped, base, 0.7)
        elif smoother == "grouped":
            sm = plane_gs_grouped(*args, group=8, pc_dtype=pc_dtype)
        elif smoother == "plane_gs":
            sm = plane_gs_layered(*args, pc_dtype=pc_dtype,
                                  row_ptr=op.row_ptr)
        else:
            raise ValueError(f"smoother={smoother!r}: expected one of "
                             f"{SMOOTHERS}")
        smoothers.append(sm)

    def restrict(k, r):
        # sum rows into aggregates (R = P^T for 0/1 prolongation)
        c = ops[k + 1]
        rc = r.new_zeros((c.n2d * c.n_planes, bs))
        rc.index_add_(0, hierarchy.levels[k].node_map, r.reshape(-1, bs))
        if fine is not None and k == 0:
            rc = fine.reduce(rc)
        return rc.reshape(-1)

    def prolong(k, xc):
        return xc.reshape(-1, bs)[hierarchy.levels[k].node_map].reshape(-1)

    def cycle(k, r):
        if k == len(ops) - 1:
            if coarse_apply is not None:
                return coarse_apply(r)
            x = smoothers[k](r)
            for _ in range(n_coarse_sweeps - 1):
                x = x + smoothers[k](r - matvecs[k](x))
            return x
        x = smoothers[k](r)                       # pre-smooth
        res = r - matvecs[k](x)
        rc = restrict(k, res)
        xc = cycle(k + 1, rc)
        if cycle_type == "w" and k + 1 < len(ops) - 1:
            # W-cycle: a second coarse correction on the remaining
            # coarse-level residual
            xc = xc + cycle(k + 1, rc - matvecs[k + 1](xc))
        x = x + prolong(k, xc)
        x = x + smoothers[k](r - matvecs[k](x))   # post-smooth
        return x

    def apply(r):
        return cycle(0, r)

    return apply


SMOOTHERS = ("plane_gs", "jacobi", "cheby", "zebra", "linej", "line",
             "lined", "grouped")


def _node_jacobi32(Vk, diag_pos, mk32):
    """Node-block Jacobi of a level's values, its inverses in float32."""
    bs = Vk.shape[0]
    d = Vk[:, :, 1, diag_pos, :].permute(3, 2, 0, 1).reshape(-1, bs, bs)
    return block_jacobi(d.to(torch.float32), mk32)


def _jacobi_sweeps(Dinv, mv, omega, r):
    """Two damped node-block Jacobi sweeps from 0."""
    x = omega * Dinv(r)
    return x + omega * Dinv(r - mv(x))


def _chebyshev(Dinv, mv32, ub, q, r):
    """The degree-q Chebyshev polynomial in D^-1 A on [ub / alpha, ub],
    in float32."""
    lb = ub / CHEBY_ALPHA
    theta = 0.5 * (ub + lb)
    delta = 0.5 * (ub - lb)
    sigma = theta / delta
    rf = r.to(torch.float32)
    x = Dinv(rf) / theta
    dx = x
    rho = 1.0 / sigma
    for _ in range(q - 1):
        res = rf - mv32(x)
        rho_new = 1.0 / (2.0 * sigma - rho)
        dx = (rho_new * rho) * dx + (2.0 * rho_new / delta) * Dinv(res)
        x = x + dx
        rho = rho_new
    return x.to(r.dtype)


def _line_jacobi(base, Dinv, mv, omega, r):
    """A damped line solve, then a damped node-block Jacobi correction."""
    x = omega * base(r)
    return x + omega * Dinv(r - mv(x))


def _damped(base, omega, r):
    return omega * base(r)


def _dense_coarse_inverse(op: LevelOperator):
    """Dense float32 inverse of the coarsest (projected) level plus two
    Newton-Schulz polish steps; returns r -> A^-1 r in r's dtype.  The
    inverse stays float32 whatever the V-cycle's value dtype: a bf16
    inverse of the ill-conditioned coarse operator injects kappa*eps noise
    that stalls the whole cycle."""
    Vk, mk, nk, Lk = op.values, op.mask, op.n2d, op.n_planes
    bs, Ek = Vk.shape[0], Vk.shape[3]
    dev = Vk.device
    N = nk * Lk
    # entry V[:, :, d, e, l] couples block row (l, row_ids[e]) to block
    # col (l+d-1, cols[e])
    d_g = torch.arange(3, device=dev)[:, None, None] - 1
    e_g = torch.arange(Ek, device=dev)[None, :, None]
    l_g = torch.arange(Lk, device=dev)[None, None, :]
    lcol = l_g + d_g
    Rb = l_g * nk + op.row_ids[e_g]                       # (3, Ek, Lk)
    Cb = torch.where((lcol >= 0) & (lcol < Lk), lcol, Lk) * nk \
        + op.cols[e_g]
    idx = torch.where(Cb < N, Rb * N + Cb, N * N).reshape(-1)
    blocks = Vk.permute(2, 3, 4, 0, 1).reshape(-1, bs, bs).to(torch.float32)
    Ad = torch.zeros((N * N + 1, bs, bs), dtype=torch.float32, device=dev)
    Ad.index_add_(0, idx, blocks)
    Ad = Ad[:N * N].reshape(N, N, bs, bs).permute(0, 2, 1, 3) \
        .reshape(N * bs, N * bs)
    # Vk is already P A P projected; add the (I - P) rows
    Ad = Ad + torch.diag(1.0 - mk.to(torch.float32))
    Ainv = torch.linalg.inv(Ad)
    Id = torch.eye(Ad.shape[0], dtype=Ad.dtype, device=dev)
    for _ in range(2):
        Ainv = Ainv + Ainv @ (Id - Ad @ Ainv)

    def coarse_apply(r):
        return (Ainv @ r.to(torch.float32)).to(r.dtype)

    return coarse_apply
