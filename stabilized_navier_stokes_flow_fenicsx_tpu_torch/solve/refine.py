"""Iterative-refinement Newton: the reference's 1e-8 from a float32 solve.

Counterpart of the JAX package's ``solve/refine.py``.  A float32 Newton
floors at ~1e-6 relative residual: f32 assembly cannot measure the
residual any finer.  Refinement continues from the f32 solution with the
iterate and the residual in float64, while the Jacobian, the
preconditioner and the inner FGMRES stay in the solve dtype (classical
mixed-precision iterative refinement: the correction equation needs a
few digits, the residual all of them).  Convergence is linear at a rate
of ~cond(J) eps_f32 per step, to the reference SNES's rtol = atol = 1e-8
(reference NavierStokes/NavierStokesChannelFlow.py:281-283) in a handful
of cheap steps.

The JAX package evaluates that residual in two-f32 "double-float"
arithmetic and carries the iterate as an unevaluated hi + lo pair,
because the TPU has no float64.  The card has it natively, so here the
residual is the ordinary kernel assembled in float64 on float64 geometry
(the mesh's own points, not the f32 coordinates cast up, which would
define another discrete problem) and the iterate is one f64 tensor.
``RefineResult`` still reports the JAX pair: ``x_hi`` (the iterate
rounded to the solve dtype) and ``x_lo`` (the exact f64 remainder).

The loop runs on the host, as the JAX ``lax.while_loop`` would step it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .krylov import _norm, fgmres


def refine_enabled(mode: str, dtype: torch.dtype) -> bool:
    """``SolverConfig.refine`` for a solve in ``dtype``: "on" forces
    refinement, "auto" takes it exactly for float32, anything else is
    off."""
    return mode == "on" or (mode == "auto" and dtype == torch.float32)


@dataclasses.dataclass
class RefineResult:
    x_hi: torch.Tensor     # the iterate rounded to the solve dtype
    x_lo: torch.Tensor     # f64 remainder: x_hi + x_lo is the f64 iterate
    iters: int
    resnorm: float         # ||F|| of the f64 residual at the iterate
    converged: bool
    # per step (iters, 3): [||F|| after the step, KSP iters, KSP |r|]
    history: np.ndarray

    @property
    def x(self) -> torch.Tensor:
        """The f64 iterate (exactly ``x_hi + x_lo``)."""
        return self.x_hi.to(torch.float64) + self.x_lo


def refine_newton(
    residual64: Callable,          # f64 x -> f64 F(x) (BC rows substituted)
    jac_values: Callable,          # solve-dtype x -> values of dF/dx
    make_operator: Callable,       # values -> A(x) closure
    make_pc: Callable,             # values -> M(x) closure
    x0: torch.Tensor,              # the Newton solution (solve dtype)
    n0: float,                     # ||F|| at the start of that Newton
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 10,
    ksp_rtol: float = 1e-2,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 8,
) -> RefineResult:
    """Push ||F|| below max(rtol n0, atol) with f64 residuals.

    SNES semantics: n0 is the residual norm at the start of the overall
    nonlinear solve, so rtol means what it means to PETSc.  Each step
    solves J dx = -F in the solve dtype (one FGMRES) and adds dx in f64.
    No line search: refinement starts inside Newton's basin.  A step that
    fails to reduce ||F|| (the Jacobian too inaccurate, or the floor
    reached) is recorded, its iterate dropped, and the loop stops."""
    dtype = x0.dtype
    x = x0.to(torch.float64)
    F = residual64(x)
    fnorm = _norm(F)
    tol = max(rtol * float(n0), atol)
    hist = []
    it, stalled = 0, False
    while fnorm > tol and it < max_it and not stalled:
        vals = jac_values(x.to(dtype))
        sol = fgmres(make_operator(vals), (-F).to(dtype), M=make_pc(vals),
                     rtol=ksp_rtol, restart=ksp_restart,
                     max_restarts=ksp_max_restarts)
        x_new = x + sol.x.to(torch.float64)
        F_new = residual64(x_new)
        fnew = _norm(F_new)
        hist.append([fnew, float(sol.iters), sol.resnorm])
        stalled = not fnew < fnorm          # also on a NaN step
        if not stalled:
            x, F, fnorm = x_new, F_new, fnew
        it += 1
    x_hi = x.to(dtype)
    return RefineResult(x_hi, x - x_hi.to(torch.float64), it, fnorm,
                        fnorm <= tol,
                        np.asarray(hist, np.float64).reshape(-1, 3))
