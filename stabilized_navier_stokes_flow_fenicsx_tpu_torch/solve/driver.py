"""Solve drivers on the block-CSR and layered operators.

Counterpart of the JAX package's ``solve/driver.py`` — the equivalents
of ``fem.petsc.LinearProblem`` and the SNES driver (reference
NavierStokesChannelFlow.py:197-218, 268-312).  Each is a plain function
on tensors with the JAX package's positional signature: assembly,
preconditioner setup and the Krylov/Newton iterations run eagerly on the
tensors' device, with the loop control on the host.  The double-float
refinement drivers (``refine_newton_*``) and the stepped drivers are not
ported.
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
from .krylov import KrylovResult, cg, fgmres
from .newton import NewtonResult, newton_solve
from .precond import block_jacobi


def parse_mg_pc(pc: str):
    """Parse ``mg_cheby[<degree>][_bf16]`` into (cheby_degree, dtype);
    e.g. mg_cheby_bf16, mg_cheby4_bf16.  The default degree is 6.
    Returns None for any other name."""
    m = re.fullmatch(r"mg_cheby(\d*)(_bf16)?", pc)
    if m is None:
        return None
    return (int(m.group(1)) if m.group(1) else 6,
            torch.bfloat16 if m.group(2) else None)


def _layered_pc(pc, arrays: LayeredArrays, n2d, n_planes, mask, mg=None):
    """PC factory for the layered operator: values -> closure.

    'mg_cheby*' names (grammar in ``parse_mg_pc``) -> aggregation
    multigrid with the Chebyshev smoother (solve/mg.py), which needs the
    ``mg`` hierarchy; any other non-mg name -> node-block Jacobi.  The
    JAX package's other multigrid smoothers (plane Gauss-Seidel, zebra,
    line) are not ported and raise.
    """
    if pc.startswith(("mg", "plane_gs", "zebra", "line_")):
        mg_pat = parse_mg_pc(pc)
        if mg_pat is None:
            raise NotImplementedError(
                f"pc={pc!r}: only the mg_cheby* multigrid is ported")
        if mg is None:
            raise ValueError(f"pc={pc!r} needs a build_mg_hierarchy result")
        from .mg import make_mg_pc

        degree, dt = mg_pat

        def make(values):
            return make_mg_pc(
                mg, values, arrays.cols, arrays.row_ids, arrays.row_ptr,
                arrays.diag_pos, mask, n2d, n_planes, pc_dtype=dt,
                cheby_degree=degree)
        return make

    def make(values):
        return block_jacobi(layered_diag_blocks(arrays, n2d, values), mask)
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
    pc: str = "mg_cheby_bf16",
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
    r = residual_layered(kernel, n2d, n_planes, bs, arrays, w)
    return float(torch.linalg.vector_norm(mask * r + (1.0 - mask) * (w - g)))


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
    pc: str = "mg_cheby_bf16",
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
