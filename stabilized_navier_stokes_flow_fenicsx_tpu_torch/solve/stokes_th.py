"""Taylor-Hood solve on the device: fieldsplit-preconditioned FGMRES.

Counterpart of the JAX package's ``solve/stokes_th.py``.  The reference
solves the P2-P1 system with MUMPS (StokesFlow/DuctStokesFlow.py:213-216).

Two iterative designs were measured before landing on this one:

* diagonal-preconditioned MINRES on the symmetric saddle point stagnates
  at ~3e-3 (scipy.sparse.linalg.minres does too — the indefinite system
  is too ill-conditioned for a pointwise PC);
* nested Uzawa (outer MINRES on S = B^T A^{-1} B, inner CG on A) works
  for smooth inlet data but diverges along a near-null Schur mode for the
  uniform-inlet duct: with inexact inner solves the outer null component
  grows unboundedly and contaminates u (measured: rel-p blowup ~5e11).

The robust standard structure is FGMRES on the FULL system with the
block-upper-triangular preconditioner (PETSc fieldsplit schur/upper):

    M = [[A_hat, B], [0, -S_hat]],   S_hat = (1/nu) * lumped M_p

    zp = -nu * M_p^{-1} rp
    zu = A_hat^{-1} (ru - B zp)      (A_hat^{-1}: Jacobi-CG, loose rtol)

With exact blocks the preconditioned operator has minimal polynomial of
degree 2; with the spectrally-equivalent pressure mass and an inexact
velocity solve the outer count is small and mesh-independent (the
flexible Arnoldi basis absorbs the varying inner iteration).  All block
actions come from ONE assembled symmetric block-CSR matrix via component
masking — no extraction: momentum rows of K give [A u + B p], continuity
rows give B^T u.

Both Krylov loops run on the host (solve/krylov.py) with their vectors on
the tensors' device: each inner CG step reads two scalars back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..assemble.assembly import AsmArrays, bcsr_matvec
from .krylov import cg, fgmres


class THSchurResult(NamedTuple):
    x: torch.Tensor
    outer_iters: int
    resnorm: float
    converged: bool
    inner_iters: int = 0          # Jacobi-CG steps over all PC applications


def solve_th_schur(
    ndofs: int,
    n_rows: int,
    arrays: AsmArrays,
    values: torch.Tensor,         # symmetric block-CSR values (bs = 1)
    b: torch.Tensor,              # BC-reduced RHS (linear_system's b_bc)
    mask: torch.Tensor,           # 1 on free dofs
    mv: torch.Tensor,             # 1 on velocity dofs
    mp_diag: torch.Tensor,        # lumped pressure mass on pressure dofs
    rtol: float = 1e-10,
    nu: float = 1.0,
    inner_rtol: float = 1e-2,
    max_outer: int = 400,
    max_inner: int = 200,
) -> THSchurResult:
    mvf = mask * mv               # free velocity dofs
    mpf = mask * (1.0 - mv)       # free pressure dofs

    def K(x):
        return bcsr_matvec(arrays, n_rows, values, x)

    def K_bc(x):                  # BC rows replaced by identity
        return mask * K(mask * x) + (1.0 - mask) * x

    def A_op(x):                  # SPD on free velocity dofs
        return mvf * K(mvf * x) + (1.0 - mvf) * x

    diag = values[arrays.diag_pos].reshape(-1)
    dv = mvf / diag.abs().clamp(min=1e-300) + (1.0 - mvf)

    def Minner(x):
        return dv * x

    mp_inv = mpf / mp_diag.clamp(min=1e-300)
    inner = [0]

    def Mfs(r):
        """Block-upper-triangular fieldsplit preconditioner."""
        zp = -nu * mp_inv * (mpf * r)
        ru = mvf * (r - K(zp))            # momentum rows of K(zp) = B zp
        sol = cg(A_op, ru, M=Minner, rtol=inner_rtol, max_it=max_inner)
        inner[0] += sol.iters
        return mvf * sol.x + zp + (1.0 - mask) * r

    out = fgmres(K_bc, b, M=Mfs, rtol=rtol, restart=60,
                 max_restarts=max_outer // 60 + 1)
    return THSchurResult(out.x, int(out.iters), float(out.resnorm),
                         bool(out.converged), inner[0])
