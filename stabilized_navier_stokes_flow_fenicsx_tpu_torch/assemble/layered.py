"""Layered (plane-structured) block operator for extruded meshes.

Counterpart of the JAX package's ``assemble/layered.py``.  The channel
mesh is an extrusion: node = (plane l, 2D node i), and every matrix block
couples (l, i) -> (l + delta, j) with delta in {-1, 0, +1} and j in the
2D cross-section adjacency of i.  The Jacobian is block-tridiagonal over
planes with the SAME 2D sparsity in every plane:

    y[l, i] = sum_e sum_delta  V[e, delta, l] @ x[l + delta, col(e)]

where e runs over the directed 2D adjacency pairs, sorted by row.  The
SpMV is kernel K1 (``layered_spmv.py``).  Unused nodes (the solid splitter
interior) stay in the dense (Lp, n2d) node grid as identity rows masked by
the BC machinery.

The port builds the structured-SoA assembly route only (the JAX
package's ``NS_TPU_*`` build switches select the routes it does not
port).  ``build_layered`` is a span of the same name
(utils/profiling.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..fem.space import MixedVelocityPressureSpace
from ..utils.device import row_ptr_of, upload
from ..utils.profiling import traced
from .assembly import ASM_CHUNK, residual_of
from .layered_spmv import LayeredOperand
from .structured import (StructuredAsm, build_structured_plan,
                         matrix_values_structured, residual_structured)


@dataclasses.dataclass
class LayeredArrays:
    """Device tensors of the layered operator (index tables int64)."""

    cell_dofs: torch.Tensor       # (nc, ndl) plane-major dof ids
    cell_coords: torch.Tensor     # (nc, nv, 3)
    ell_pos: torch.Tensor         # (nc, nbl, nbl) -> (e*3 + d)*Lp + l
    cols: torch.Tensor            # (E,) 2D column node of each pair
    row_ids: torch.Tensor         # (E,) 2D row node (sorted)
    row_ptr: torch.Tensor         # (n2d + 1,) CSR pointer of row_ids
    diag_pos: torch.Tensor        # (n2d,) pair id of the (i, i) pair
    # the structured assembly plan; None on a pattern without one (padded
    # planes, a mesh without the extrusion grid): the plane-sharded path
    # (parallel/layered_shard.py) assembles from the cell tables instead
    sasm: Optional[StructuredAsm]

    @classmethod
    def from_numpy(cls, fields: Mapping, sasm: Optional[StructuredAsm],
                   device) -> "LayeredArrays":
        """Upload host fields (by name); ``row_ptr`` is derived from the
        sorted ``row_ids`` when absent."""
        n2d = len(fields["diag_pos"])
        row_ptr = fields.get("row_ptr")
        if row_ptr is None:
            row_ptr = row_ptr_of(fields["row_ids"], n2d)
        names = ("cell_dofs", "cell_coords", "ell_pos", "cols", "row_ids",
                 "diag_pos")
        return cls(row_ptr=upload(row_ptr, device), sasm=sasm,
                   **{k: upload(fields[k], device) for k in names})


@dataclasses.dataclass
class LayeredPattern:
    n2d: int
    n_planes: int                # Lp = number of node planes
    E: int                       # directed 2D pairs (incl. self)
    bs: int
    arrays: LayeredArrays
    rows2d: np.ndarray           # host copies of the pair list (MG setup)
    cols2d: np.ndarray

    @property
    def nnzb(self) -> int:
        return self.E * 3 * self.n_planes

    @property
    def ndofs(self) -> int:
        return self.n2d * self.n_planes * self.bs


@traced("build_layered")
def build_layered(
    space: MixedVelocityPressureSpace,
    n2d: int,
    n_planes: int,
    dtype: Optional[torch.dtype] = None,
    device=None,
    chunk_cells: int = ASM_CHUNK,
) -> LayeredPattern:
    """Build the layered pattern for an extruded equal-order mixed space.

    Node ids must be plane-major: node = l * n2d + i (the layout
    mesh/extrude.py emits before compaction).  Host numpy/native up to the
    final upload to ``device``.

    ``n_planes`` may exceed the mesh's own plane count (the plane-sharded
    path pads it to a multiple of the rank count), and the mesh may lack
    the extrusion grid (the duct): the pair list and the cell tables are
    built all the same and ``arrays.sasm`` is None.  The single-process
    structured route (``matrix_values_layered``, ``residual_layered``)
    raises on such a pattern.

    ``chunk_cells``: the cells one call of the structured route's plain
    SoA twin takes on the CPU (``structured._chunks``), and so the
    padding of the plan's columns; on the card K4 takes the whole mesh in
    one launch.
    """
    from ..config import default_dtype

    dtype = default_dtype() if dtype is None else dtype
    mesh = space.mesh
    bs = space.block_size
    nbl = mesh.cells.shape[1]
    Lp = n_planes

    # fused native pass (csrc/meshops.cpp::build_layered_pattern): the
    # sorted 2D pair list AND the final per-cell scatter ids
    from ..utils.native import build_layered_pattern_native

    fused = build_layered_pattern_native(mesh.cells, n2d, Lp)
    if fused is not None:
        cols2d, rows2d, diag_pos, ell_pos, E = fused
    else:
        cells = mesh.cells.astype(np.int64)
        l_of = cells // n2d                  # (nc, 4) plane index
        i_of = cells % n2d                   # (nc, 4) 2D node index

        la = np.repeat(l_of, nbl, axis=1).ravel()
        lb = np.tile(l_of, (1, nbl)).ravel()
        delta = lb - la
        if delta.min() < -1 or delta.max() > 1:
            raise ValueError("not a 1-layer extrusion")

        from ..utils.native import build_pattern_native

        nat = build_pattern_native(i_of.astype(np.int32), n2d)
        if nat is not None:
            _indptr, cols2d, rows2d, inv_pos, diag_pos = nat
            E = len(cols2d)
            inv = inv_pos.reshape(-1).astype(np.int64)
        else:
            ia = np.repeat(i_of, nbl, axis=1).ravel()
            ib = np.tile(i_of, (1, nbl)).ravel()
            keys = ia * n2d + ib
            uniq, inv = np.unique(keys, return_inverse=True)
            E = len(uniq)
            rows2d = (uniq // n2d).astype(np.int32)
            cols2d = (uniq % n2d).astype(np.int32)
            diag_keys = np.arange(n2d, dtype=np.int64) * (n2d + 1)
            diag_pos = np.searchsorted(uniq, diag_keys)
            if not (uniq[diag_pos] == diag_keys).all():
                raise ValueError("missing diagonal pairs")
        # (delta d, pair e, row plane l) -> segment id; delta-major so
        # the value tensor lands in the (bs, bs, 3, E, Lp) layout
        seg = ((delta + 1) * E + inv) * Lp + la
        ell_pos = seg.reshape(mesh.cells.shape[0], nbl, nbl) \
            .astype(np.int32)

    nnz_layer = E * 3 * Lp
    nc = mesh.cells.shape[0]
    nc_pad = nc if nc <= ASM_CHUNK else -(-nc // ASM_CHUNK) * ASM_CHUNK
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    pts = np.ascontiguousarray(mesh.points, dtype=np_dtype)
    cc_p = np.empty((nc_pad,) + (nbl, pts.shape[1]), np_dtype)
    cc_p[:nc] = pts[mesh.cells]
    cdw = np.asarray(space.cell_dofs_w, np.int32)
    cd_p = np.empty((nc_pad, cdw.shape[1]), np.int32)
    cd_p[:nc] = cdw
    ep_p = np.empty((nc_pad, nbl, nbl), np.int32)
    ep_p[:nc] = ell_pos
    if nc_pad > nc:
        cc_p[nc:] = cc_p[0]          # padded cells reuse cell 0 coords
        cd_p[nc:] = space.ndofs      # scatter into the trash dof
        ep_p[nc:] = nnz_layer        # scatter into the trash segment

    sasm = build_structured_plan(mesh, cd_p, cc_p, ep_p, n2d, Lp, E, bs,
                                 device, chunk_cells=chunk_cells)
    arrays = LayeredArrays.from_numpy(dict(
        cell_dofs=cd_p, cell_coords=cc_p, ell_pos=ep_p, cols=cols2d,
        row_ids=rows2d, diag_pos=diag_pos), sasm, device)
    return LayeredPattern(n2d, Lp, E, bs, arrays,
                          np.asarray(rows2d), np.asarray(cols2d))


def layered_arrays_in(arrays: LayeredArrays, mesh,
                      dtype: torch.dtype) -> LayeredArrays:
    """``arrays`` (built by ``build_layered`` for ``mesh``) with every
    coordinate table rebuilt from ``mesh.points`` in ``dtype``; the index
    tables and the structured plan are shared, and arrays already in
    ``dtype`` come back as they are.  The f64 residual of iterative
    refinement (solve/refine.py) assembles on it: the f32 coordinates
    cast up would define another discrete problem."""
    if arrays.cell_coords.dtype == dtype:
        return arrays
    dev = arrays.cell_coords.device
    nc, nc_pad = mesh.cells.shape[0], arrays.cell_coords.shape[0]
    ids = torch.zeros(nc_pad, dtype=torch.int64, device=dev)
    ids[:nc] = torch.arange(nc, device=dev)     # padded cells: cell 0
    pts = torch.as_tensor(np.asarray(mesh.points), dtype=dtype, device=dev)
    cc = pts[upload(mesh.cells, dev)[ids]]      # (nc_pad, nv, 3)
    sasm = arrays.sasm
    if sasm is not None:
        if sasm.cell_ids is None:
            raise ValueError("the structured plan has no cell_ids (a plan "
                             "converted from the JAX package's)")
        scc = cc[sasm.cell_ids]
        sasm = dataclasses.replace(
            sasm, cell_coords=scc,
            coordsT=scc.reshape(scc.shape[0], -1).T.contiguous())
    return dataclasses.replace(arrays, cell_coords=cc, sasm=sasm)


def _plan(arrays: LayeredArrays) -> StructuredAsm:
    if arrays.sasm is None:
        raise ValueError("mesh does not carry the layer-invariant "
                         "extrusion grid the structured assembly needs")
    return arrays.sasm


def matrix_values_layered(
    kernel: Callable,
    E: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    w: torch.Tensor,
) -> torch.Tensor:
    """Layered Jacobian values V (bs, bs, 3, E, Lp): V[i, j, d, e, l] is
    the (row-component i, col-component j) entry of the block for layer
    offset d-1, pair e, row plane l."""
    return matrix_values_structured(kernel, E, n_planes, bs, _plan(arrays),
                                    w)


def residual_layered(
    kernel: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    w: torch.Tensor,
) -> torch.Tensor:
    """Global residual on the layered path: the SoA structured route when
    the kernel has an SoA variant, the generic ``residual_of`` otherwise
    (the Stokes kernel)."""
    if kernel.res_soa is not None:
        return residual_structured(kernel, n_planes, _plan(arrays), w)
    return residual_of(kernel, n2d * n_planes * bs, arrays, w)


def layered_matvec(
    arrays,
    n2d: int,
    n_planes: int,
    values: torch.Tensor,         # (bs, bs, 3, E, Lp)
    x: torch.Tensor,              # (ndofs,)
) -> torch.Tensor:
    """y = A x in the layered format (``arrays`` carries the pair list:
    ``cols``, ``row_ptr``).  Kernel K1 on a CUDA tensor, its plain
    version on a CPU tensor; a one-off call (the RHS lift), so it
    prepares the operand for this call alone."""
    return LayeredOperand(values, arrays.cols, arrays.row_ptr, n2d)(x)


def make_layered_op(arrays, n2d: int, n_planes: int,
                    values: torch.Tensor, mask: torch.Tensor) -> Callable:
    """BC-projected operator A(x) = P A P x + (I - P) x: K1's prepared
    operand with the projection fused in."""
    return LayeredOperand(values, arrays.cols, arrays.row_ptr, n2d,
                          mask=mask)


def layered_diag_blocks(arrays, n2d: int,
                        values: torch.Tensor) -> torch.Tensor:
    """(Lp * n2d, bs, bs) node-diagonal blocks (delta = 0, self pairs)."""
    bs = values.shape[0]
    d = values[:, :, 1, arrays.diag_pos, :]   # (bs, bs, n2d, Lp)
    return d.permute(3, 2, 0, 1).reshape(-1, bs, bs)
