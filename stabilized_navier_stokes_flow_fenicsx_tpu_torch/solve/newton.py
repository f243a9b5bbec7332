"""Damped Newton with FGMRES inner solves — the SNES equivalent.

Counterpart of the JAX package's ``solve/newton.py::newton_solve`` with
the host loop in place of ``lax.while_loop``.  The reference sets
rtol=atol=1e-8, max_it=30 (NavierStokesChannelFlow.py:268-312); a
backtracking line search on ||F|| stands in for SNES's default 'bt' line
search.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .krylov import fgmres


@dataclasses.dataclass
class NewtonResult:
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool
    # per-iteration history (iters, 4):
    #   [|F| after step, line-search lambda, KSP iters, KSP final resnorm]
    history: np.ndarray
    # True when the line search failed outright and the full step did not
    # reduce ||F|| (SNES would report a line-search divergence); the
    # pre-step iterate is kept and ``converged`` is False.
    stalled: bool = False


def _norm(v: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(v))


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
) -> NewtonResult:
    """Newton to ||F|| <= max(rtol ||F(x0)||, atol) with FGMRES steps
    and a backtracking line search (Armijo factor 1 - 1e-4 lambda)."""
    x = x0
    F = residual(x0)
    fnorm = _norm(F)
    tol = max(rtol * fnorm, atol)
    hist = []
    it, stalled = 0, False
    while fnorm > tol and it < max_it and not stalled:
        vals = jac_values(x)
        sol = fgmres(make_operator(vals), -F, M=make_pc(vals),
                     rtol=ksp_rtol, restart=ksp_restart,
                     max_restarts=ksp_max_restarts)
        dx = sol.x

        # backtracking on ||F||; the full step's trial is kept for the
        # "take the full step anyway" case
        lam, accepted = 1.0, False
        F1 = n1 = None
        for k in range(max_backtracks):
            Ft = residual(x + lam * dx)
            trial = _norm(Ft)
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
            # divergence semantics); hist still records the rejected step
            x = x + lam * dx
            F, fnorm = F_new, new_norm
        it += 1
    history = np.asarray(hist, np.float64).reshape(-1, 4)
    return NewtonResult(x, it, fnorm, fnorm <= tol, history, stalled)
