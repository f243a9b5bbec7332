"""Generic element assembly: batched element kernels + index_add scatter
into node-block CSR.

Counterpart of the JAX package's ``assemble/assembly.py`` (the
replacement for DOLFINx/FFCx assembly, SURVEY.md 2.2).  Every form is an
element residual kernel ``kernel(coords_e (nv, gdim), w_e (ndl,)) -> r_e
(ndl,)``, either an ``ElementKernel`` (utils/kernelbase.py) or a plain
callable, and everything else is derived:

* global residual = ``index_add_`` over the batched kernel (the JAX
  ``segment_sum``),
* global Jacobian = the kernel's analytic tangent (``kernel.jac``) or
  ``torch.func.jacfwd`` of the kernel, under ``torch.func.vmap``, scattered
  into node-block CSR values (nnzb, bs, bs),
* linear forms = the affine case: A = J(0), b = -r(0).

Cells stream through in ``ASM_CHUNK``-sized chunks, the last one ragged,
so no cell padding is needed.  The Jacobian scatter is one ``index_add_``
of (nc nbl nbl, bs, bs) blocks at ``ell_pos``: the same sums as the JAX
package's bs^2 strided segment sums, in another order.  The JAX package's
gather-plan assembly (``build_gather_plan``, a TPU scatter work-around)
is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import default_device, default_dtype
from ..fem.bc import DirichletBC, bc_mask, bc_vector
from ..fem.space import FunctionSpace, MixedVelocityPressureSpace
from ..utils.device import upload
from ..utils.linalg import det_small, inv_small

# cells per assembly chunk: bounds the batched-kernel intermediates (the
# same chunk the host plans pad to)
ASM_CHUNK = 65536


def affine_geometry(coords: torch.Tensor, dim: int):
    """Jacobian data for an affine simplex.

    coords: (nv, gdim) vertex coordinates (first dim+1 rows are vertices).
    Returns (J (dim, dim), invJ (dim, dim), absdetJ scalar) with
    J[i, k] = d x_i / d xi_k and invJ[k, i] = d xi_k / d x_i.
    """
    E = coords[1:dim + 1, :] - coords[0:1, :]    # rows = edge vectors
    J = E.T
    return J, inv_small(J), det_small(J).abs()


def cell_diameter(coords: torch.Tensor) -> torch.Tensor:
    """UFL CellDiameter: max vertex-vertex distance (longest edge)."""
    d = coords[:, None, :] - coords[None, :, :]
    return torch.sqrt((d * d).sum(-1).max())


@dataclasses.dataclass
class AsmArrays:
    """Device tensors of the generic assembly (index tables int64)."""

    cell_dofs: torch.Tensor       # (nc, ndl)
    cell_coords: torch.Tensor     # (nc, nv, gdim)
    indices: torch.Tensor         # (nnzb,) block column ids
    row_ids: torch.Tensor         # (nnzb,) block row ids (sorted)
    ell_pos: torch.Tensor         # (nc, nbl, nbl) -> nnz position
    diag_pos: torch.Tensor        # (n_rows,) position of diagonal block

    @classmethod
    def from_numpy(cls, fields: Mapping, device,
                   dtype: Optional[torch.dtype] = None) -> "AsmArrays":
        """Upload host fields (by name); coordinates in ``dtype`` (their
        own when None)."""
        out = {k: upload(fields[k], device)
               for k in ("cell_dofs", "cell_coords", "indices", "row_ids",
                         "ell_pos", "diag_pos")}
        if dtype is not None:
            out["cell_coords"] = out["cell_coords"].to(dtype)
        return cls(**out)


# ----------------------------------------------------------------------------
# Block-CSR pattern (host-side, numpy)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class BlockPattern:
    """CSR over node blocks, plus the element->nnz scatter map."""

    n_rows: int                 # number of block rows
    bs: int                     # block size
    indptr: np.ndarray          # (n_rows+1,)
    indices: np.ndarray         # (nnzb,) block column ids
    row_ids: np.ndarray         # (nnzb,) block row id of each stored block
    ell_pos: np.ndarray         # (n_cells, nbl, nbl) -> nnz position
    diag_pos: np.ndarray        # (n_rows,) position of diagonal block

    @property
    def nnzb(self) -> int:
        return self.indices.shape[0]

    def to_scipy(self, values):
        """Block CSR -> scipy.sparse for host-side checks."""
        from scipy.sparse import bsr_matrix

        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        return bsr_matrix(
            (np.asarray(values), self.indices, self.indptr),
            shape=(self.n_rows * self.bs, self.n_rows * self.bs),
        )


def build_pattern(cell_blocks: np.ndarray, n_blocks: int, bs: int
                  ) -> BlockPattern:
    """Sparsity from element block connectivity.

    cell_blocks: (n_cells, nbl) block ids touched by each cell (e.g. the
    scalar-node connectivity for an equal-order mixed space).  Uses the
    native sort/unique (csrc/meshops.cpp) when it builds; the numpy
    fallback gives identical arrays.
    """
    from ..utils.native import build_pattern_native

    nat = build_pattern_native(cell_blocks, n_blocks)
    if nat is not None:
        indptr, indices, row_ids, ell_pos, diag_pos = nat
        return BlockPattern(
            n_rows=n_blocks, bs=bs, indptr=indptr, indices=indices,
            row_ids=row_ids, ell_pos=ell_pos, diag_pos=diag_pos)
    return _build_pattern_np(cell_blocks, n_blocks, bs)


def _build_pattern_np(cell_blocks: np.ndarray, n_blocks: int, bs: int
                      ) -> BlockPattern:
    nc, nbl = cell_blocks.shape
    rows = np.repeat(cell_blocks, nbl, axis=1).ravel()
    cols = np.tile(cell_blocks, (1, nbl)).ravel()
    keys = rows.astype(np.int64) * n_blocks + cols.astype(np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    u_rows = (uniq // n_blocks).astype(np.int32)
    u_cols = (uniq % n_blocks).astype(np.int32)
    indptr = np.zeros(n_blocks + 1, dtype=np.int32)
    np.add.at(indptr, u_rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    ell_pos = inv.reshape(nc, nbl, nbl).astype(np.int32)
    diag_keys = np.arange(n_blocks, dtype=np.int64) * (n_blocks + 1)
    diag_pos = np.searchsorted(uniq, diag_keys).astype(np.int32)
    return BlockPattern(
        n_rows=n_blocks, bs=bs, indptr=indptr, indices=u_cols,
        row_ids=u_rows, ell_pos=ell_pos, diag_pos=diag_pos)


# ----------------------------------------------------------------------------
# Functional assembly (tensors in, tensors out)
# ----------------------------------------------------------------------------


def residual_of(kernel: Callable, ndofs: int, arrays,
                w: torch.Tensor) -> torch.Tensor:
    """Global residual r(w) = scatter(sum_e kernel_e).

    ``arrays`` carries ``cell_dofs`` (nc, ndl) and ``cell_coords``
    (nc, nv, gdim); padded cells (the layered plans pad to whole chunks)
    point at the trash dof ``ndofs``, which reads 0 from w and absorbs
    their scatter.
    """
    w_ext = torch.cat([w, w.new_zeros(1)])
    cd_all, cc_all = arrays.cell_dofs, arrays.cell_coords
    out = w.new_zeros(ndofs + 1)
    batched = torch.func.vmap(kernel)
    for c0 in range(0, cd_all.shape[0], ASM_CHUNK):
        cd = cd_all[c0:c0 + ASM_CHUNK]
        r_e = batched(cc_all[c0:c0 + ASM_CHUNK], w_ext[cd])
        out.index_add_(0, cd.reshape(-1), r_e.reshape(-1))
    return out[:ndofs]


def _cell_jacobians(kernel: Callable, cell_coords, cell_dofs, w):
    """(nc, ndl, ndl) element Jacobians: the kernel's analytic tangent
    when it has one (``kernel.jac``), else jacfwd of the kernel — which
    also serves plain-callable kernels (Poisson)."""
    w_ext = torch.cat([w, w.new_zeros(1)])
    jac = getattr(kernel, "jac", None)
    if jac is not None:
        return torch.func.vmap(jac)(cell_coords, w_ext[cell_dofs])

    def cell_jac(coords, w_e):
        return torch.func.jacfwd(lambda ww: kernel(coords, ww))(w_e)

    return torch.func.vmap(cell_jac)(cell_coords, w_ext[cell_dofs])


def matrix_values_of(kernel: Callable, nnzb: int, bs: int,
                     arrays: AsmArrays, w: torch.Tensor) -> torch.Tensor:
    """Block-CSR values of dr/dw at w: (nnzb, bs, bs).

    Each chunk's (ch, ndl, ndl) element Jacobians are regrouped into
    (ch nbl nbl, bs, bs) node blocks and added at ``ell_pos``."""
    cd_all, cc_all, ep_all = (arrays.cell_dofs, arrays.cell_coords,
                              arrays.ell_pos)
    nbl = ep_all.shape[1]
    out = w.new_zeros((nnzb, bs, bs))
    for c0 in range(0, cd_all.shape[0], ASM_CHUNK):
        sl = slice(c0, c0 + ASM_CHUNK)
        J = _cell_jacobians(kernel, cc_all[sl], cd_all[sl], w)
        ch = J.shape[0]
        blocks = J.reshape(ch, nbl, bs, nbl, bs).transpose(2, 3)
        out.index_add_(0, ep_all[sl].reshape(-1),
                       blocks.reshape(-1, bs, bs))
    return out


def bcsr_matvec(arrays: AsmArrays, n_rows: int, values: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """y = A x with A in block-CSR: a gather of x's blocks, a batched
    (bs x bs) product, an ``index_add_`` over the block rows."""
    bs = values.shape[-1]
    xb = x.reshape(-1, bs)
    contrib = torch.einsum("nij,nj->ni", values, xb[arrays.indices])
    yb = x.new_zeros((n_rows, bs)).index_add_(0, arrays.row_ids, contrib)
    return yb.reshape(-1)


# ----------------------------------------------------------------------------
# Assembler — binds a space to its pattern/arrays, offers convenience API
# ----------------------------------------------------------------------------


class Assembler:
    """A mesh's dofmap, block pattern and device arrays; its methods run
    on the arrays' device (the card unless ``device`` says otherwise)."""

    def __init__(
        self,
        cell_dofs: np.ndarray,
        cell_coords: np.ndarray,
        ndofs: int,
        pattern: BlockPattern,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        self.ndofs = int(ndofs)
        self.dtype = default_dtype() if dtype is None else dtype
        self.device = default_device() if device is None \
            else torch.device(device)
        self.pattern = pattern
        self.arrays = AsmArrays.from_numpy(dict(
            cell_dofs=cell_dofs, cell_coords=cell_coords,
            indices=pattern.indices, row_ids=pattern.row_ids,
            ell_pos=pattern.ell_pos, diag_pos=pattern.diag_pos),
            self.device, self.dtype)

    def vector(self, a) -> torch.Tensor:
        """A host array as a dof-sized tensor of the assembler's dtype and
        device."""
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def residual(self, kernel: Callable, w: torch.Tensor) -> torch.Tensor:
        return residual_of(kernel, self.ndofs, self.arrays, w)

    def matrix_values(self, kernel: Callable, w: torch.Tensor
                      ) -> torch.Tensor:
        return matrix_values_of(
            kernel, self.pattern.nnzb, self.pattern.bs, self.arrays, w)

    def matvec(self, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return bcsr_matvec(self.arrays, self.pattern.n_rows, values, x)

    def diag_blocks(self, values: torch.Tensor) -> torch.Tensor:
        return values[self.arrays.diag_pos]

    # -- BC-aware wrappers ---------------------------------------------------
    def bc_operator(self, values: torch.Tensor, mask: torch.Tensor
                    ) -> Callable:
        """A_bc(x) = P A P x + (I - P) x (rows+cols projected)."""

        def op(x):
            return mask * self.matvec(values, mask * x) + (1.0 - mask) * x

        return op

    def bc_residual(self, kernel, w, mask, g) -> torch.Tensor:
        """Residual with Dirichlet rows replaced by (w - g)."""
        r = self.residual(kernel, w)
        return mask * r + (1.0 - mask) * (w - g)

    def linear_system(
        self, kernel: Callable, bc: DirichletBC,
    ) -> Tuple[torch.Tensor, Callable, torch.Tensor, torch.Tensor]:
        """For affine kernels: (values, A_bc, b_bc, mask).

        Solves of A_bc x = b_bc satisfy the BC exactly and the weak form on
        free dofs (same solution as dolfinx LinearProblem with lifting,
        reference NavierStokesChannelFlow.py:197-218).
        """
        zero = torch.zeros(self.ndofs, dtype=self.dtype, device=self.device)
        values = self.matrix_values(kernel, zero)
        b = -self.residual(kernel, zero)
        mask = self.vector(bc_mask(self.ndofs, bc))
        g = self.vector(bc_vector(self.ndofs, bc))
        b_bc = mask * (b - self.matvec(values, g)) + g
        return values, self.bc_operator(values, mask), b_bc, mask


def asm_arrays_in(arrays: AsmArrays, mesh, dtype: torch.dtype) -> AsmArrays:
    """``arrays`` (built for ``mesh``) with the cell coordinates taken
    anew from ``mesh.points`` in ``dtype``; the index tables are shared,
    and arrays already in ``dtype`` come back as they are.  The f64
    residual of iterative refinement (solve/refine.py) assembles on it:
    the f32 coordinates cast up would define another discrete problem."""
    if arrays.cell_coords.dtype == dtype:
        return arrays
    return dataclasses.replace(arrays, cell_coords=torch.as_tensor(
        np.asarray(mesh.points)[mesh.cells], dtype=dtype,
        device=arrays.cell_coords.device))


def assembler_for_mixed(space: MixedVelocityPressureSpace, dtype=None,
                        device=None) -> Assembler:
    mesh = space.mesh
    coords = mesh.points[mesh.cells]
    if space.equal_order:
        pattern = build_pattern(
            space.V.cell_dofs_scalar, space.V.n_scalar_dofs, space.block_size)
    else:
        pattern = build_pattern(space.cell_dofs_w, space.ndofs, 1)
    return Assembler(space.cell_dofs_w, coords, space.ndofs, pattern, dtype,
                     device)


def assembler_for_space(fs: FunctionSpace, dtype=None,
                        device=None) -> Assembler:
    mesh = fs.mesh
    coords = mesh.points[mesh.cells]
    cd = fs.cell_dofs()
    pattern = build_pattern(fs.cell_dofs_scalar, fs.n_scalar_dofs, fs.vs)
    return Assembler(cd, coords, fs.ndofs, pattern, dtype, device)
