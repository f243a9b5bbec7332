"""Point location + P1 interpolation on simplex meshes (host half).

Host replacement for DOLFINx's non-matching interpolation with
padding=1e-6: 2D inlet profiles onto 3D inlet facet dofs and coarse->fine
solution transfer (reference NavierStokes/NavierStokesChannelFlow.py:
150-157, 175-194).

Instead of a bb-tree, cells are binned into a uniform grid over the mesh
bbox; queries are vectorized numpy gathers over the padded per-bin
candidate lists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..mesh.core import SimplexMesh


@dataclasses.dataclass
class GridLocator:
    """Uniform-grid cell locator over a simplex mesh (dim = 2 or 3)."""

    dim: int
    lo: np.ndarray              # (dim,)
    inv_h: np.ndarray           # (dim,)
    shape: Tuple[int, ...]      # bins per axis
    bin_start: np.ndarray       # (n_bins+1,) CSR offsets
    bin_cells: np.ndarray       # (total,) cell ids sorted by bin
    max_per_bin: int
    # mesh data for barycentric tests
    x0: np.ndarray              # (nc, dim) first vertex
    Tinv: np.ndarray            # (nc, dim, dim) inverse edge matrix
    cells: np.ndarray           # (nc, dim+1)

    @property
    def n_bins(self) -> int:
        return int(np.prod(self.shape))


def build_locator(mesh: SimplexMesh, bins_per_axis: Optional[int] = None
                  ) -> GridLocator:
    pts = mesh.points[:, : mesh.dim]
    cells = mesh.cells
    nc = cells.shape[0]
    dim = mesh.dim
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    if bins_per_axis is None:
        # bin edge ~ 1 mean cell size per axis: keeps max_per_bin small
        # (the padded candidate tables scale query memory by max_per_bin)
        vol = float(np.prod(span))
        h_mean = (vol / max(nc, 1)) ** (1 / dim)
        shape = tuple(
            int(np.clip(np.ceil(span[d] / h_mean), 1, 512))
            for d in range(dim))
    else:
        shape = tuple(
            max(1, min(bins_per_axis,
                       int(np.ceil(bins_per_axis * span[d] / span.max()))))
            for d in range(dim))
    h = span / np.array(shape)
    inv_h = 1.0 / h

    cp = pts[cells]                                  # (nc, nv, dim)
    cmin = ((cp.min(axis=1) - lo) * inv_h).astype(np.int64)
    cmax = ((cp.max(axis=1) - lo) * inv_h).astype(np.int64)
    cmin = np.clip(cmin, 0, np.array(shape) - 1)
    cmax = np.clip(cmax, 0, np.array(shape) - 1)

    pair_bins = []
    pair_cells = []
    # enumerate covered bins per cell (cells span few bins; loop over offsets)
    spans = cmax - cmin
    max_span = spans.max(axis=0)
    for off in np.ndindex(*(max_span + 1)):
        off = np.array(off)
        ok = (off <= spans).all(axis=1)
        idx = cmin[ok] + off
        flat = np.ravel_multi_index(idx.T, shape)
        pair_bins.append(flat)
        pair_cells.append(np.nonzero(ok)[0])
    bins = np.concatenate(pair_bins)
    cls = np.concatenate(pair_cells)
    order = np.argsort(bins, kind="stable")
    bins = bins[order]
    cls = cls[order].astype(np.int32)
    n_bins = int(np.prod(shape))
    start = np.zeros(n_bins + 1, dtype=np.int64)
    np.add.at(start, bins + 1, 1)
    start = np.cumsum(start)
    max_per_bin = int(np.diff(start).max()) if len(cls) else 1

    E = cp[:, 1 : dim + 1, :] - cp[:, 0:1, :]        # (nc, dim, dim) rows=edges
    Tinv = np.linalg.inv(np.transpose(E, (0, 2, 1)))  # inverse of column mat
    return GridLocator(
        dim=dim, lo=lo, inv_h=inv_h, shape=shape,
        bin_start=start, bin_cells=cls, max_per_bin=max_per_bin,
        x0=cp[:, 0, :].copy(), Tinv=Tinv, cells=cells)


def _candidates_np(loc: GridLocator, q: np.ndarray) -> np.ndarray:
    """Padded candidate cells per query point, -1 padded: (nq, max_per_bin)."""
    idx = ((q - loc.lo) * loc.inv_h).astype(np.int64)
    idx = np.clip(idx, 0, np.array(loc.shape) - 1)
    flat = np.ravel_multi_index(idx.T, loc.shape)
    s = loc.bin_start[flat]
    e = loc.bin_start[flat + 1]
    n = len(q)
    out = np.full((n, loc.max_per_bin), -1, dtype=np.int32)
    for k in range(loc.max_per_bin):
        has = s + k < e
        out[has, k] = loc.bin_cells[(s + k)[has]]
    return out


def locate_np(loc: GridLocator, q: np.ndarray, tol: float = 1e-6
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Find containing cells (or -1) and barycentric coords for points.

    tol plays the role of dolfinx's interpolation ``padding``
    (NavierStokesChannelFlow.py:155): points within tol of a cell count
    as inside.
    """
    q = np.asarray(q, dtype=np.float64)[:, : loc.dim]
    cand = _candidates_np(loc, q)                    # (nq, K)
    K = cand.shape[1]
    safe = np.maximum(cand, 0)
    rel = q[:, None, :] - loc.x0[safe]               # (nq, K, dim)
    lam = np.einsum("nkij,nkj->nki", loc.Tinv[safe], rel)  # (nq, K, dim)
    lam0 = 1.0 - lam.sum(axis=2)
    allbar = np.concatenate([lam0[:, :, None], lam], axis=2)  # (nq,K,dim+1)
    valid = (cand >= 0) & (allbar.min(axis=2) >= -tol)
    first = np.argmax(valid, axis=1)
    found = valid.any(axis=1)
    cell = np.where(found, cand[np.arange(len(q)), first], -1)
    bary = allbar[np.arange(len(q)), first]
    return cell.astype(np.int32), bary


def interpolate_p1_np(
    mesh: SimplexMesh,
    values: np.ndarray,
    q: np.ndarray,
    loc: Optional[GridLocator] = None,
    fill: float = 0.0,
    tol: float = 1e-6,
) -> np.ndarray:
    """Evaluate a P1 field (nodal values, possibly vector) at points."""
    if loc is None:
        loc = build_locator(mesh)
    cell, bary = locate_np(loc, q, tol)
    vals = np.asarray(values)
    vcell = vals[mesh.cells[np.maximum(cell, 0)]]    # (nq, nv, ...) nodal
    out = np.einsum("nv,nv...->n...", bary, vcell)
    if out.ndim == 1:
        return np.where(cell >= 0, out, fill)
    return np.where((cell >= 0)[:, None], out, fill)
