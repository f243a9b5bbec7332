"""Point location + P1 interpolation on simplex meshes.

Replacement for two DOLFINx facilities (SURVEY.md 2.2):

* non-matching interpolation with padding=1e-6 — 2D inlet profiles onto
  3D inlet facet dofs and coarse->fine solution transfer (reference
  NavierStokes/NavierStokesChannelFlow.py:150-157, 175-194): the host
  half, vectorized numpy;
* the bounding-box-tree point lookup + ``uh.eval`` pair that the
  streamtracer calls per RK stage (reference streamtrace.py:144-157): the
  device half, batched torch gathers over a ``(n, 3)`` query tensor on
  the locator's device.

Instead of a bb-tree, cells are binned into a uniform grid over the mesh
bbox; both halves query the same padded per-bin candidate lists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import default_dtype
from ..mesh.core import SimplexMesh
from ..utils.device import upload


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


# ---- device query path (the batched streamtracer) --------------------------


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none is):
    ``jnp.argmax`` of a bool array.  torch.argmax takes no bool and
    returns the first maximal index."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


@dataclasses.dataclass
class DeviceLocator:
    """GridLocator data as tensors + a padded per-bin candidate table.

    The CSR bin lists are densified to (n_bins, max_per_bin) so a query is
    three gathers and a vectorized barycentric test — no data-dependent
    shapes anywhere.
    """

    dim: int
    lo: torch.Tensor
    inv_h: torch.Tensor
    shape: Tuple[int, ...]
    table: torch.Tensor           # (n_bins, K) int64, -1 padded
    x0: torch.Tensor
    Tinv: torch.Tensor
    cells: torch.Tensor


def _bin_slots(loc: GridLocator):
    """(row, slot) of every CSR entry of ``loc``'s bins in the dense
    (n_bins, max_per_bin) table."""
    counts = np.diff(loc.bin_start)
    rows = np.repeat(np.arange(loc.n_bins), counts)
    slot = np.arange(len(loc.bin_cells)) - np.repeat(loc.bin_start[:-1],
                                                     counts)
    return rows, slot


def _real(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def device_locator(loc: GridLocator, dtype: Optional[torch.dtype] = None,
                   device=None) -> DeviceLocator:
    dtype = default_dtype() if dtype is None else dtype
    table = np.full((loc.n_bins, loc.max_per_bin), -1, np.int64)
    rows, slot = _bin_slots(loc)
    table[rows, slot] = loc.bin_cells
    return DeviceLocator(
        dim=loc.dim, lo=_real(loc.lo, dtype, device),
        inv_h=_real(loc.inv_h, dtype, device), shape=tuple(loc.shape),
        table=upload(table, device), x0=_real(loc.x0, dtype, device),
        Tinv=_real(loc.Tinv, dtype, device), cells=upload(loc.cells, device))


def recover_extrusion(mesh: SimplexMesh):
    """Recover (x_planes, n2d, tris2d, tri_of_prism, layer_of_prism)
    from a bare extruded tet mesh, or None.

    The channel meshes are x-plane extrusions with plane-major nodes and
    3-tets-per-prism cells (mesh/extrude.py) — but the product pipeline
    re-reads meshes from XDMF (reference InletBatchScript.py:39-52), which
    drops that provenance.  This detects the structure geometrically so
    the streamtrace locator can exploit it on re-read meshes too.  All
    checks are exact (the XDMF round-trip preserves coordinates bit-for-
    bit); any failure returns None and callers fall back to the general
    grid locator.
    """
    pts = np.asarray(mesh.points)
    if mesh.cell != "tetrahedron" or pts.shape[1] != 3:
        return None
    cells = np.asarray(mesh.cells)
    if len(cells) % 3:
        return None
    x = pts[:, 0]
    xs = np.unique(x)
    Lp = len(xs)
    n = len(pts)
    if Lp < 2 or Lp > 4096 or n % Lp:
        return None
    n2d = n // Lp
    X = x.reshape(Lp, n2d)
    if (X != X[:, :1]).any() or (X[:, 0] != xs).any():
        return None
    yz = pts[:, 1:].reshape(Lp, n2d, 2)
    if (yz != yz[:1]).any():
        return None
    # prisms: consecutive cell triples (extrude order: tet-minor)
    ids = cells.reshape(-1, 12)
    lay = ids.min(axis=1) // n2d
    if (ids // n2d != lay[:, None]).sum() * 2 != ids.size:
        return None                       # not exactly half top-plane
    loc2 = np.sort(ids % n2d, axis=1)
    new = np.concatenate(
        [np.ones((len(loc2), 1), bool), loc2[:, 1:] != loc2[:, :-1]],
        axis=1)
    if (new.sum(axis=1) != 3).any():
        return None                       # prism footprint must be a tri
    tri_nodes = loc2[new].reshape(-1, 3)  # (n_prisms, 3) sorted node ids
    # unique rows via scalar int64 keys: positional encoding preserves
    # lexicographic order, and 1-D np.unique is ~10x faster than axis=0
    # (which sorts a structured view) at the 484k-prism bench mesh.
    if n2d >= 1 << 21:
        # key max ~ n2d^3 would overflow int64 and silently collide
        # distinct triangles; fall back to the exact (slower) row-unique.
        tris, tri_of = np.unique(tri_nodes, axis=0, return_inverse=True)
    else:
        n2d64 = np.int64(n2d)
        key = (tri_nodes[:, 0].astype(np.int64) * n2d64
               + tri_nodes[:, 1]) * n2d64 + tri_nodes[:, 2]
        ukey, tri_of = np.unique(key, return_inverse=True)
        tris = np.stack([ukey // (n2d64 * n2d64),
                         (ukey // n2d64) % n2d64,
                         ukey % n2d64], axis=1)
    return xs, n2d, tris.astype(np.int32), tri_of.astype(np.int32), \
        lay.astype(np.int32)


@dataclasses.dataclass
class LayeredDeviceLocator:
    """Extrusion-aware point locator (the streamtrace hot path).

    The general grid locator pays K=max_per_bin candidate gathers per
    query.  On an extruded channel a query is instead:

      * x-layer: a sorted search in the (Lp,) plane array,
      * ONE row gather of ``tab2[bin]`` — all K2 2D candidates WITH
        their inlined (x0, Tinv) triangle geometry in a single (K2, 7)
        row — followed by vectorized barycentric tests,
      * ONE scalar gather of ``prism_base[tri * nl + layer]``,
      * ONE row gather of ``prism_geom[prism]`` — the (36,) packed
        (x0, Tinv) of the prism's three sub-tets.
    """

    nl: int                       # layers = Lp - 1
    nt: int                       # 2D triangles
    shape2: Tuple[int, int]       # 2D grid bins
    x_planes: torch.Tensor        # (Lp,)
    lo2: torch.Tensor             # (2,) 2D grid origin
    inv_h2: torch.Tensor          # (2,)
    tab2: torch.Tensor            # (n_bins, K2, 7): [tri, x0(2), Tinv(4)]
    prism_base: torch.Tensor      # (nt * nl,) int64: 3*prism or -1 (dead)
    prism_geom: torch.Tensor      # (n_prisms, 36): 3 x [x0(3), Tinv(9)]
    cells: torch.Tensor           # (nc, 4) int64


def _cell_geometry_device(pts: torch.Tensor, cells: torch.Tensor):
    """(x0, Tinv) per tet, batched on the device.

    Tinv = inv(E^T) with E the (3,3) edge matrix, via the closed-form
    adjugate — three cross products and one dot.
    """
    cp = pts[cells]                                   # (nc, 4, 3)
    x0 = cp[:, 0, :]
    e = cp[:, 1:4, :] - cp[:, 0:1, :]                 # (nc, 3, 3) rows e_k
    # M = E^T has columns e_k  ->  inv(M) rows = cross(e_j, e_k) / det
    c0 = torch.linalg.cross(e[:, 1], e[:, 2])
    c1 = torch.linalg.cross(e[:, 2], e[:, 0])
    c2 = torch.linalg.cross(e[:, 0], e[:, 1])
    det = (e[:, 0] * c0).sum(dim=1)[:, None, None]
    # Degenerate tets (|det| ~ 0) get NaN Tinv rows: NaN barycentrics
    # fail every ``>= -tol`` test (in torch as in numpy), so points in
    # such a cell locate as outside (cell = -1) instead of silently
    # mislocating on inf values.
    scale = e.abs().amax(dim=(1, 2))[:, None, None] ** 3
    bad = det.abs() <= 1e-14 * scale.clamp_min(1e-300)
    det = torch.where(bad, torch.full_like(det, float("nan")), det)
    Tinv = torch.stack([c0, c1, c2], dim=1) / det
    return x0, Tinv


def _prism_pack_device(pts: torch.Tensor, cells: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Per-tet (x0, Tinv) geometry packed into per-prism (36,) rows."""
    x0, Tinv = _cell_geometry_device(pts, cells)
    return torch.cat([x0, Tinv.reshape(-1, 9)], dim=1).reshape(
        -1, 36).to(dtype)


def build_layered_locator(mesh: SimplexMesh,
                          dtype: Optional[torch.dtype] = None, device=None
                          ) -> Optional[LayeredDeviceLocator]:
    """LayeredDeviceLocator from a (possibly re-read) extruded channel
    mesh, or None when the mesh is not a recoverable extrusion."""
    rec = recover_extrusion(mesh)
    if rec is None:
        return None
    xs, n2d, tris, tri_of, lay = rec
    dtype = default_dtype() if dtype is None else dtype
    nl = len(xs) - 1
    nt = len(tris)
    if nt >= 1 << 24:
        return None      # tri ids are carried as floats in tab2 (f32-exact)
    mesh2d = SimplexMesh("triangle", np.asarray(mesh.points)[:n2d, 1:3],
                         tris)
    loc2 = build_locator(mesh2d)
    base = np.full(nt * nl, -1, np.int64)
    base[tri_of * nl + lay] = np.arange(len(tri_of), dtype=np.int64) * 3
    # Packed 2D candidate table: candidate ids AND triangle geometry in
    # one (K2, 7) row — a query gathers one row instead of 1 + 2*K2.
    tab2 = np.zeros((loc2.n_bins, loc2.max_per_bin, 7), np.float64)
    tab2[:, :, 0] = -1.0
    rows, slot = _bin_slots(loc2)
    ids = loc2.bin_cells
    tab2[rows, slot, 0] = ids
    tab2[rows, slot, 1:3] = loc2.x0[ids]
    tab2[rows, slot, 3:7] = loc2.Tinv[ids].reshape(-1, 4)
    # Per-cell geometry (x0, Tinv) is computed on the device in float64
    # and cast to dtype after, so sliver-cell barycentric tests stay
    # within the 1e-6 tolerance.
    pts = _real(mesh.points, torch.float64, device)
    cells = upload(mesh.cells, device)
    # prism-packed tet geometry: cells are 3 consecutive tets per prism
    # (mesh/extrude.py order, verified by recover_extrusion)
    return LayeredDeviceLocator(
        nl=nl, nt=nt, shape2=tuple(loc2.shape),
        x_planes=_real(xs, dtype, device), lo2=_real(loc2.lo, dtype, device),
        inv_h2=_real(loc2.inv_h, dtype, device),
        tab2=_real(tab2, dtype, device), prism_base=upload(base, device),
        prism_geom=_prism_pack_device(pts, cells, dtype), cells=cells)


def _grid_bin(q: torch.Tensor, lo: torch.Tensor, inv_h: torch.Tensor,
              shape: Tuple[int, ...]) -> torch.Tensor:
    """Flat (row-major) grid bin of each query row, clamped to the grid
    (the float -> int cast truncates toward zero, as the JAX cast does)."""
    idx = ((q - lo) * inv_h).to(torch.int64)
    flat = idx[:, 0].clamp(0, shape[0] - 1)
    for d in range(1, len(shape)):
        flat = flat * shape[d] + idx[:, d].clamp(0, shape[d] - 1)
    return flat


def locate_device_layered(dloc: LayeredDeviceLocator, q: torch.Tensor,
                          tol: float = 1e-6):
    """Point location on the layered locator for a batch q (n, 3):
    (cell id or -1 (n,), barycentric (n, 4)) — the contract of
    locate_device."""
    n = q.shape[0]
    ar = torch.arange(n, device=q.device)
    xp = dloc.x_planes
    q0 = q[:, 0].contiguous()
    # sum(q0 >= xp) - 1, as a sorted search
    lay = (torch.searchsorted(xp, q0, right=True) - 1).clamp(0, dloc.nl - 1)
    in_x = (q0 >= xp[0] - tol) & (q0 <= xp[-1] + tol)
    # 2D locate from the packed row
    q2 = q[:, 1:3]
    row = dloc.tab2[_grid_bin(q2, dloc.lo2, dloc.inv_h2, dloc.shape2)]
    rel = q2[:, None, :] - row[:, :, 1:3]                 # (n, K2, 2)
    l1 = row[:, :, 3] * rel[:, :, 0] + row[:, :, 4] * rel[:, :, 1]
    l2 = row[:, :, 5] * rel[:, :, 0] + row[:, :, 6] * rel[:, :, 1]
    bmin = torch.minimum(torch.minimum(1.0 - l1 - l2, l1), l2)
    ok2 = (row[:, :, 0] >= 0) & (bmin >= -tol)
    tri = torch.where(ok2.any(dim=1),
                      row[ar, _first_true(ok2), 0].to(torch.int64), -1)
    base = dloc.prism_base[tri.clamp_min(0) * dloc.nl + lay]
    base = torch.where((tri >= 0) & in_x, base, -1)
    g3 = dloc.prism_geom[base.clamp_min(0) // 3].view(n, 3, 12)
    rel3 = q[:, None, :] - g3[:, :, :3]                   # (n, 3, 3)
    Ti = g3[:, :, 3:].reshape(n, 3, 3, 3)
    lam = (Ti * rel3[:, :, None, :]).sum(dim=3)           # (n, 3, 3)
    lam0 = 1.0 - lam.sum(dim=2, keepdim=True)
    bar = torch.cat([lam0, lam], dim=2)                   # (n, 3, 4)
    valid = (base >= 0)[:, None] & (bar.amin(dim=2) >= -tol)
    first = _first_true(valid)
    cell = torch.where(valid.any(dim=1), base.clamp_min(0) + first, -1)
    return cell, bar[ar, first]


def locate_device(dloc: DeviceLocator, q: torch.Tensor, tol: float = 1e-6):
    """Point location on the general grid locator for a batch q
    (n, dim): (cell id or -1 (n,), barycentric (n, dim+1))."""
    n = q.shape[0]
    ar = torch.arange(n, device=q.device)
    cand = dloc.table[_grid_bin(q, dloc.lo, dloc.inv_h, dloc.shape)]
    safe = cand.clamp_min(0)                              # (n, K)
    rel = q[:, None, :] - dloc.x0[safe]                   # (n, K, dim)
    lam = (dloc.Tinv[safe] * rel[:, :, None, :]).sum(dim=3)
    lam0 = 1.0 - lam.sum(dim=2, keepdim=True)
    bar = torch.cat([lam0, lam], dim=2)                   # (n, K, dim+1)
    valid = (cand >= 0) & (bar.amin(dim=2) >= -tol)
    first = _first_true(valid)
    cell = torch.where(valid.any(dim=1), cand[ar, first], -1)
    return cell, bar[ar, first]


def locate_any(dloc, q: torch.Tensor, tol: float = 1e-6):
    """Locate on whichever locator type ``dloc`` is."""
    if isinstance(dloc, LayeredDeviceLocator):
        return locate_device_layered(dloc, q, tol)
    return locate_device(dloc, q, tol)


def build_trace_locator(mesh: SimplexMesh,
                        dtype: Optional[torch.dtype] = None, device=None):
    """Best available device locator for the streamtracer: the layered
    one when the mesh is a recoverable extrusion, else the general grid
    locator."""
    dl = build_layered_locator(mesh, dtype, device)
    if dl is not None:
        return dl
    return device_locator(build_locator(mesh), dtype, device)
