"""Flexible GMRES with right preconditioning.

Counterpart of the JAX package's ``solve/krylov.py::fgmres`` (the
config-default Krylov method).  The vectors live on the device; the
(m+1) x m Hessenberg matrix, its Givens rotations and the least-squares
back-substitution are a few hundred scalars, so they live on the host,
with one device->host read of the new Hessenberg column per Arnoldi step
(where the JAX loop tested its ``done`` flag on the device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class KrylovResult:
    x: torch.Tensor
    iters: int             # Arnoldi steps performed over all cycles
    resnorm: float         # final true residual norm |b - A x|
    converged: bool


def _ident(x):
    return x


def fgmres(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 50,
    max_restarts: int = 40,
) -> KrylovResult:
    """FGMRES(m): Arnoldi with modified Gram-Schmidt; the Z basis stores
    preconditioned vectors, so M may itself be an inner iteration.  Each
    restart cycle ends with an exact residual recompute, and the solve
    stops when |b - A x| <= max(rtol |b|, atol) or after
    ``max_restarts`` cycles."""
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    m = restart
    tol = max(rtol * float(torch.linalg.vector_norm(b)), atol)

    def arnoldi_cycle(x):
        r = b - A(x)
        beta = float(torch.linalg.vector_norm(r))
        V = b.new_zeros((m + 1, n))
        Z = b.new_zeros((m, n))
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        V[0] = r / beta if beta > 0 else r
        steps = 0
        for j in range(m):
            z = M(V[j])
            w = A(z)
            h = []
            for i in range(j + 1):
                hij = torch.dot(V[i], w)
                w = w - hij * V[i]
                h.append(hij)
            hj1 = torch.linalg.vector_norm(w)
            H[:j + 2, j] = torch.stack(h + [hj1]).tolist()
            V[j + 1] = w / hj1 if H[j + 1, j] > 0 else w
            Z[j] = z
            # previous Givens rotations on column j, then the new one
            for i in range(j):
                hi = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = hi
            denom = math.sqrt(H[j, j] ** 2 + H[j + 1, j] ** 2)
            c = H[j, j] / denom if denom > 0 else 1.0
            s = H[j + 1, j] / denom if denom > 0 else 0.0
            H[j, j] = c * H[j, j] + s * H[j + 1, j]
            H[j + 1, j] = 0.0
            cs[j], sn[j] = c, s
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            steps += 1
            if abs(g[j + 1]) <= tol:
                break
        # back-substitution on the triangularized H (columns never
        # formed have H[j, j] = 0 -> y_j = 0)
        y = np.zeros(m)
        for j in reversed(range(m)):
            num = g[j] - H[j, j + 1:] @ y[j + 1:]
            y[j] = num / H[j, j] if abs(H[j, j]) > 0 else 0.0
        yt = torch.as_tensor(y[:steps], dtype=b.dtype, device=b.device)
        return x + yt @ Z[:steps], steps

    rn = float(torch.linalg.vector_norm(b - A(x)))
    cycles = its = 0
    while rn > tol and cycles < max_restarts:
        x, steps = arnoldi_cycle(x)
        # exact residual recompute per cycle (the Givens estimate drifts
        # under a low-precision preconditioner)
        rn = float(torch.linalg.vector_norm(b - A(x)))
        cycles += 1
        its += steps
    return KrylovResult(x, its, rn, rn <= tol)
