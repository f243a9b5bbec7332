"""Solve drivers on the block-CSR and layered operators.

Counterpart of the JAX package's ``solve/driver.py`` — the equivalents
of ``fem.petsc.LinearProblem`` and the SNES driver (reference
NavierStokesChannelFlow.py:197-218, 268-312).  Each is a plain function
on tensors with the JAX package's positional signature: assembly,
preconditioner setup and the Krylov/Newton iterations run eagerly on the
tensors' device, with the loop control on the host.  The refinement
drivers (``refine_newton_layered``, ``refine_newton_bcsr``) take an f64
residual where the JAX package's take a double-float one
(solve/refine.py); the stepped drivers, a work-around for the TPU's
remote compiler, are not ported.
"""

from __future__ import annotations

import re
from typing import Callable

import torch

from ..assemble.assembly import (
    AsmArrays, bcsr_matvec, matrix_values_of, residual_of)
from ..assemble.layered import (
    LayeredArrays, layered_diag_blocks, layered_matvec, make_layered_op,
    matrix_values_layered, residual_layered)
from ..utils.profiling import read, span
from .krylov import KrylovResult, cg, fgmres
from .newton import NewtonResult, newton_solve
from .refine import RefineResult, refine_newton
from .precond import (block_jacobi, line_cr_layered, plane_gs_grouped,
                      plane_gs_layered, plane_zebra_layered)


def parse_mg_pc(pc: str):
    """Parse an mg PC name into (smoother, cheby_degree, cycle, dtype).

    Grammar: ``mg[_<smoother>][<cheby_degree>][w][_bf16]``, e.g. mg (the
    plane-GS V-cycle), mg_cheby_bf16, mg_cheby4_bf16 (degree-4
    Chebyshev), mg_chebyw_bf16 (W-cycle).  The default degree is 6.
    Returns None for any other name."""
    m = re.fullmatch(
        r"mg(?:_(jacobi|cheby|grouped|lined|linej|line|zebra))?"
        r"(\d*)(w?)(_bf16)?", pc)
    if m is None:
        return None
    return (m.group(1) or "plane_gs",
            int(m.group(2)) if m.group(2) else 6,
            "w" if m.group(3) else "v",
            torch.bfloat16 if m.group(4) else None)


def _layered_pc(pc, arrays: LayeredArrays, n2d, n_planes, mask, mg=None):
    """PC factory for the layered operator: values -> closure.

    'mg*' names (grammar in ``parse_mg_pc``) -> aggregation multigrid
    (solve/mg.py), which needs the ``mg`` hierarchy; 'zebra[_bf16]',
    'line_cr[_bf16]', 'plane_gs[_bf16]' (4x fewer Krylov iterations than
    block Jacobi on the channel) and 'plane_gs_grouped' (8 planes
    jointly) -> those relaxations alone (solve/precond.py); any other name
    -> node-block Jacobi.
    """
    dt = torch.bfloat16 if pc.endswith("_bf16") else None
    mg_pat = parse_mg_pc(pc)
    if mg_pat is not None:
        if mg is None:
            raise ValueError(f"pc={pc!r} needs a build_mg_hierarchy result")
        from .mg import make_mg_pc

        sm, degree, cyc, dt = mg_pat

        def make(values):
            return make_mg_pc(
                mg, values, arrays.cols, arrays.row_ids, arrays.row_ptr,
                arrays.diag_pos, mask, n2d, n_planes, pc_dtype=dt,
                smoother=sm, cycle_type=cyc, cheby_degree=degree)
    elif pc in ("zebra", "zebra_bf16"):
        def make(values):
            return plane_zebra_layered(
                values, arrays.cols, arrays.row_ids, arrays.diag_pos,
                mask, n2d, n_planes, pc_dtype=dt)
    elif pc in ("line_cr", "line_cr_bf16"):
        def make(values):
            return line_cr_layered(values, arrays.diag_pos, mask, n2d,
                                   n_planes, pc_dtype=dt)
    elif pc in ("plane_gs", "plane_gs_bf16"):
        def make(values):
            return plane_gs_layered(
                values, arrays.cols, arrays.row_ids, arrays.diag_pos,
                mask, n2d, n_planes, pc_dtype=dt, row_ptr=arrays.row_ptr)
    elif pc == "plane_gs_grouped":
        def make(values):
            return plane_gs_grouped(
                values, arrays.cols, arrays.row_ids, arrays.diag_pos,
                mask, n2d, n_planes, group=8)
    else:
        def make(values):
            return block_jacobi(layered_diag_blocks(arrays, n2d, values),
                                mask)
    return make


def _bc_op(arrays: AsmArrays, n_rows: int, values, mask) -> Callable:
    """The BC-projected block-CSR operator P A P + (I - P)."""
    def op(x):
        return mask * bcsr_matvec(arrays, n_rows, values, mask * x) \
            + (1.0 - mask) * x
    return op


def solve_linear_bcsr(
    kernel: Callable,
    ndofs: int,
    nnzb: int,
    bs: int,
    n_rows: int,
    rtol: float,
    restart: int,
    arrays: AsmArrays,
    mask: torch.Tensor,
    g: torch.Tensor,
) -> KrylovResult:
    """Assemble the affine form and solve with FGMRES + node-block Jacobi."""
    zero = torch.zeros(ndofs, dtype=mask.dtype, device=mask.device)
    values = matrix_values_of(kernel, nnzb, bs, arrays, zero)
    b = -residual_of(kernel, ndofs, arrays, zero)
    b_bc = mask * (b - bcsr_matvec(arrays, n_rows, values, g)) + g
    A = _bc_op(arrays, n_rows, values, mask)
    M = block_jacobi(values[arrays.diag_pos], mask)
    return fgmres(A, b_bc, M=M, rtol=rtol, restart=restart, max_restarts=80)


def solve_spd_cg(
    kernel: Callable,
    ndofs: int,
    rtol: float,
    arrays: AsmArrays,
    mask: torch.Tensor,
    g: torch.Tensor,
) -> KrylovResult:
    """Assemble an SPD affine form (Poisson) and solve with plain CG.

    Matrix-free: A x comes from the linearity of the residual kernel,
    A x = r(x) - r(0), so no sparsity pattern is needed (``arrays`` needs
    only ``cell_dofs`` and ``cell_coords``).  Unpreconditioned, as in the
    JAX package: the inlet Poisson systems are small and well conditioned.
    """
    zero = torch.zeros(ndofs, dtype=mask.dtype, device=mask.device)
    r0 = residual_of(kernel, ndofs, arrays, zero)

    def A_raw(x):
        return residual_of(kernel, ndofs, arrays, x) - r0

    def A(x):
        # symmetric projection P A P + (I - P): CG needs SPD
        return mask * A_raw(mask * x) + (1.0 - mask) * x

    b_bc = mask * (-r0 - A_raw(g)) + g
    return cg(A, b_bc, rtol=rtol, max_it=ndofs * 4)


def solve_linear_layered(
    kernel: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    mask: torch.Tensor,
    g: torch.Tensor,
    E: int,
    rtol: float,
    restart: int,
    pc: str = "plane_gs",
    mg=None,
) -> KrylovResult:
    """Affine form on the layered operator: A = J(0), b = -r(0) with the
    BC lift, solved by FGMRES with the chosen preconditioner."""
    zero = torch.zeros_like(mask)
    values = matrix_values_layered(kernel, E, n_planes, bs, arrays, zero)
    b = -residual_layered(kernel, n2d, n_planes, bs, arrays, zero)
    b_bc = mask * (b - layered_matvec(arrays, n2d, n_planes, values, g)) + g
    A = make_layered_op(arrays, n2d, n_planes, values, mask)
    M = _layered_pc(pc, arrays, n2d, n_planes, mask, mg)(values)
    return fgmres(A, b_bc, M=M, rtol=rtol, restart=restart, max_restarts=80)


def residual_norm_layered(
    kernel: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    mask: torch.Tensor,
    g: torch.Tensor,
    w: torch.Tensor,
    E: int,
) -> float:
    """||F(w)|| with the BC rows substituted (w - g)."""
    with span("residual"):
        r = residual_layered(kernel, n2d, n_planes, bs, arrays, w)
        return read(torch.linalg.vector_norm(mask * r
                                             + (1.0 - mask) * (w - g)))


def solve_newton_layered(
    kernel: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    mask: torch.Tensor,
    g: torch.Tensor,
    w0: torch.Tensor,
    E: int,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 30,
    ksp_rtol: float = 1e-8,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 40,
    pc: str = "plane_gs",
    mg=None,
    ksp: str = "fgmres",
) -> NewtonResult:
    """Newton on the layered operator (SNES tolerance semantics: tol =
    max(rtol ||F(w0)||, atol)) with FGMRES or TFQMR inner solves
    (``ksp``), looping on the host."""

    def residual(w):
        r = residual_layered(kernel, n2d, n_planes, bs, arrays, w)
        return mask * r + (1.0 - mask) * (w - g)

    def jac_values(w):
        return matrix_values_layered(kernel, E, n_planes, bs, arrays, w)

    def make_op(values):
        return make_layered_op(arrays, n2d, n_planes, values, mask)

    return newton_solve(
        residual, jac_values, make_op,
        _layered_pc(pc, arrays, n2d, n_planes, mask, mg), w0,
        rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
        ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts,
        ksp=ksp)


def solve_newton_bcsr(
    kernel: Callable,
    ndofs: int,
    nnzb: int,
    bs: int,
    n_rows: int,
    arrays: AsmArrays,
    mask: torch.Tensor,
    g: torch.Tensor,
    w0: torch.Tensor,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 30,
    ksp_rtol: float = 1e-8,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 40,
) -> NewtonResult:
    """Newton on a nonlinear form with BC rows substituted (SNES
    semantics), FGMRES + node-block Jacobi inner solves."""

    def residual(w):
        r = residual_of(kernel, ndofs, arrays, w)
        return mask * r + (1.0 - mask) * (w - g)

    def jac_values(w):
        return matrix_values_of(kernel, nnzb, bs, arrays, w)

    def make_op(values):
        return _bc_op(arrays, n_rows, values, mask)

    def make_pc(values):
        return block_jacobi(values[arrays.diag_pos], mask)

    return newton_solve(
        residual, jac_values, make_op, make_pc, w0,
        rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
        ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts)


def _bc_residual64(residual64: Callable, mask: torch.Tensor,
                   g64: torch.Tensor) -> Callable:
    """f64 w -> f64 F(w) with the Dirichlet rows substituted (w - g64):
    the JAX package's ``_df_bc_residual`` in plain f64.  The 0/1 mask is
    exact in any dtype; g64 must be the f64 BC values, not the solve
    dtype's cast up, or the BC rows floor at ~eps |g|."""
    m = mask.to(torch.float64)

    def residual(w):
        return m * residual64(w) + (1.0 - m) * (w - g64)

    return residual


def refine_newton_layered(
    kernel: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    E: int,
    arrays: LayeredArrays,
    arrays64: LayeredArrays,
    mask: torch.Tensor,
    g64: torch.Tensor,
    x0: torch.Tensor,
    n0: float,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 10,
    ksp_rtol: float = 1e-2,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 8,
    pc: str = "plane_gs",
    mg=None,
) -> RefineResult:
    """Iterative refinement on the layered path: the f64 residual on
    ``arrays64`` (``layered.layered_arrays_in``), the Jacobian, operator
    and preconditioner on ``arrays`` in the solve dtype (see
    solve/refine.py)."""
    residual64 = _bc_residual64(
        lambda w: residual_layered(kernel, n2d, n_planes, bs, arrays64, w),
        mask, g64)

    def jac_values(w):
        return matrix_values_layered(kernel, E, n_planes, bs, arrays, w)

    def make_op(values):
        return make_layered_op(arrays, n2d, n_planes, values, mask)

    return refine_newton(
        residual64, jac_values, make_op,
        _layered_pc(pc, arrays, n2d, n_planes, mask, mg), x0, n0,
        rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
        ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts)


def refine_newton_bcsr(
    kernel: Callable,
    ndofs: int,
    nnzb: int,
    bs: int,
    n_rows: int,
    arrays: AsmArrays,
    arrays64: AsmArrays,
    mask: torch.Tensor,
    g64: torch.Tensor,
    x0: torch.Tensor,
    n0: float,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 10,
    ksp_rtol: float = 1e-2,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 8,
) -> RefineResult:
    """Iterative refinement on the generic block-CSR path: the f64
    residual on ``arrays64`` (``assembly.asm_arrays_in``), FGMRES with
    node-block Jacobi on the diagonal blocks in the solve dtype."""
    residual64 = _bc_residual64(
        lambda w: residual_of(kernel, ndofs, arrays64, w), mask, g64)

    def jac_values(w):
        return matrix_values_of(kernel, nnzb, bs, arrays, w)

    def make_op(values):
        return _bc_op(arrays, n_rows, values, mask)

    def make_pc(values):
        return block_jacobi(values[arrays.diag_pos], mask)

    return refine_newton(
        residual64, jac_values, make_op, make_pc, x0, n0,
        rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
        ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts)
