"""Damped Newton with Krylov inner solves — the SNES equivalent.

Counterpart of the JAX package's ``solve/newton.py::newton_solve`` with
the host loop in place of ``lax.while_loop``.  The reference sets
rtol=atol=1e-8, max_it=30 (NavierStokesChannelFlow.py:268-312); a
backtracking line search on ||F|| stands in for SNES's default 'bt' line
search.  The solve, each Jacobian and each residual are spans
(``newton``, ``jacobian``, ``residual``; utils/profiling.py); steps and
line-search trials are counted (``newton_steps``,
``line_search_trials``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import count, span
from .krylov import _norm, fgmres, tfqmr

KSP_TYPES = ("fgmres", "tfqmr")


@dataclasses.dataclass
class NewtonResult:
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool
    # per-iteration history (iters, 4):
    #   [|F| after step, line-search lambda, KSP iters (TFQMR: matvecs),
    #    KSP final resnorm]
    history: np.ndarray
    # True when the line search failed outright and the full step did not
    # reduce ||F|| (SNES would report a line-search divergence); the
    # pre-step iterate is kept and ``converged`` is False.
    stalled: bool = False


def newton_solve(
    residual: Callable,            # x -> F(x)  (BC rows already substituted)
    jac_values: Callable,          # x -> values of dF/dx
    make_operator: Callable,       # values -> A(x) closure
    make_pc: Callable,             # values -> M(x) closure
    x0: torch.Tensor,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 30,
    ksp_rtol: float = 1e-8,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 40,
    max_backtracks: int = 8,
    ksp: str = "fgmres",
    reduce: Optional[Callable] = None,
) -> NewtonResult:
    """Newton to ||F|| <= max(rtol ||F(x0)||, atol) with Krylov steps and
    a backtracking line search (Armijo factor 1 - 1e-4 lambda).

    Under ranks (parallel/) ``x0`` and every vector are this rank's
    slice and ``reduce`` sums a tensor over the ranks: the norms and the
    Krylov inner products go through it.  With ``reduce=None`` nothing
    does.

    ksp="fgmres" (default) or "tfqmr", the reference's SNES KSP
    (NavierStokesChannelFlow.py:198-202); TFQMR gets FGMRES's total
    matvec budget, restart * max_restarts.  Any other name raises."""
    if ksp not in KSP_TYPES:
        raise ValueError(f"ksp={ksp!r}: expected one of {KSP_TYPES}")

    def res(x):
        with span("residual"):
            return residual(x)

    with span("newton"):
        x = x0
        F = res(x0)
        fnorm = _norm(F, reduce)
        tol = max(rtol * fnorm, atol)
        hist = []
        it, stalled = 0, False
        while fnorm > tol and it < max_it and not stalled:
            with span("jacobian"):
                vals = jac_values(x)
            A, M = make_operator(vals), make_pc(vals)
            if ksp == "tfqmr":
                sol = tfqmr(A, -F, M=M, rtol=ksp_rtol,
                            max_it=ksp_restart * ksp_max_restarts,
                            reduce=reduce)
            else:
                sol = fgmres(A, -F, M=M, rtol=ksp_rtol, restart=ksp_restart,
                             max_restarts=ksp_max_restarts, reduce=reduce)
            dx = sol.x

            # backtracking on ||F||; the full step's trial is kept for the
            # "take the full step anyway" case
            lam, accepted = 1.0, False
            F1 = n1 = None
            for k in range(max_backtracks):
                count("line_search_trials")
                Ft = res(x + lam * dx)
                trial = _norm(Ft, reduce)
                if k == 0:
                    F1, n1 = Ft, trial
                if trial < (1.0 - 1e-4 * lam) * fnorm:
                    F_new, new_norm, accepted = Ft, trial, True
                    break
                lam *= 0.5
            if not accepted:
                lam, F_new, new_norm = 1.0, F1, n1
            stalled = (not accepted) and new_norm >= fnorm
            hist.append([new_norm, lam, float(sol.iters), sol.resnorm])
            if not stalled:
                # on stall KEEP the pre-step iterate (SNES line-search
                # divergence semantics); hist still records the rejected
                # step
                x = x + lam * dx
                F, fnorm = F_new, new_norm
            it += 1
            count("newton_steps")
    history = np.asarray(hist, np.float64).reshape(-1, 4)
    return NewtonResult(x, it, fnorm, fnorm <= tol, history, stalled)
