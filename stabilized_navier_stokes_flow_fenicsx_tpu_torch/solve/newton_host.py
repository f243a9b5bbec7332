"""Newton with a host sparse-LU inner solve (the reference's MUMPS path).

Counterpart of the JAX package's ``solve/newton_host.py``.  The 2D
validation problems (DFG cylinder, lid-driven at high Re) are small and
advection-dominated; the reference solves their Newton updates with a
direct factorization (preonly+mumps, reference
Validation_Flow/DFG_2D_Validation.py:115-120, 169-189;
LidDrivenFlow/LidDrivenNavierStokesFlow.py:160-169).  This driver keeps
residual/Jacobian assembly on the assembler's device (batched kernels),
brings the values to the host once per Newton step and runs the update
solve through scipy's SuperLU — the same division of labor, with the host
factorization standing in for MUMPS.

For the large 3D systems use solve/driver.py (device Krylov) instead.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from ..assemble.assembly import Assembler, matrix_values_of, residual_of


class HostNewtonResult(NamedTuple):
    x: np.ndarray
    iters: int
    resnorm: float
    converged: bool
    history: list


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


def linear_host_lu(
    asm: Assembler,
    kernel: Callable,
    mask,
    g,
) -> np.ndarray:
    """Affine-form solve by host sparse LU (the reference's preonly+mumps
    LinearProblem, DFG_2D_Validation.py:115-120)."""
    from scipy.sparse.linalg import splu

    mask_np = _host(mask)
    g_np = _host(g)
    free = mask_np > 0.5
    pat = asm.pattern
    zero = asm.vector(np.zeros(asm.ndofs))
    values = _host(matrix_values_of(
        kernel, pat.nnzb, pat.bs, asm.arrays, zero))
    b = -_host(residual_of(kernel, asm.ndofs, asm.arrays, zero))
    A = pat.to_scipy(values).tocsr()
    rhs = b[free] - A[free][:, ~free] @ g_np[~free]
    Aff = A[free][:, free].tolil()
    # MUMPS ICNTL(24)=1 / ICNTL(25)=0 equivalent (DuctStokesFlow.py:213-216):
    # null-pivot rows (pressure dofs whose velocity couplings are all
    # constrained, e.g. inlet-rim vertices of the TH duct) get an identity
    # row and a zero value.
    rn = np.asarray(np.abs(A[free][:, free]).sum(axis=1)).ravel()
    dead = rn < 1e-12 * max(rn.max(), 1.0)
    if dead.any():
        for i in np.nonzero(dead)[0]:
            Aff[i, i] = 1.0
        rhs = np.where(dead, 0.0, rhs)
    x = g_np.copy()
    x[free] = splu(Aff.tocsc()).solve(rhs)
    return x


def newton_host_lu(
    asm: Assembler,
    kernel: Callable,
    mask,
    g,
    w0,
    rtol: float = 1e-9,
    atol: float = 1e-10,
    max_it: int = 30,
    max_backtracks: int = 10,
    timings: dict = None,
) -> HostNewtonResult:
    """Backtracking Newton: residual and Jacobian values from the
    assembler's device, the update from a host SuperLU factorization of
    the free-free block.  ``timings``, when given, accumulates the wall
    seconds of the device assembly (``assembly_s``, ending in the
    device->host copy), of the scipy conversion and free-free indexing
    (``index_s``) and of the SuperLU factor-and-solve (``lu_s``)."""
    import time

    from scipy.sparse.linalg import splu

    mask_np = _host(mask)
    g_np = _host(g)
    free = mask_np > 0.5
    pat = asm.pattern
    tm = {} if timings is None else timings
    for key in ("assembly_s", "index_s", "lu_s"):
        tm.setdefault(key, 0.0)

    def residual(w):
        t0 = time.perf_counter()
        r = _host(residual_of(kernel, asm.ndofs, asm.arrays, asm.vector(w)))
        tm["assembly_s"] += time.perf_counter() - t0
        return mask_np * r + (1.0 - mask_np) * (w - g_np)

    x = np.array(_host(w0), dtype=np.float64)
    F = residual(x)
    n0 = np.linalg.norm(F)
    tol = max(rtol * n0, atol)
    history = []
    it = 0
    while np.linalg.norm(F) > tol and it < max_it:
        t0 = time.perf_counter()
        values = _host(matrix_values_of(
            kernel, pat.nnzb, pat.bs, asm.arrays, asm.vector(x)))
        t1 = time.perf_counter()
        A = pat.to_scipy(values).tocsr()
        Aff = A[free][:, free].tocsc()
        t2 = time.perf_counter()
        lu = splu(Aff)
        dx = np.zeros_like(x)
        dx[free] = lu.solve(-F[free])
        # BC rows: keep constrained dofs pinned
        dx[~free] = -(x[~free] - g_np[~free])
        tm["assembly_s"] += t1 - t0
        tm["index_s"] += t2 - t1
        tm["lu_s"] += time.perf_counter() - t2

        fnorm = np.linalg.norm(F)
        lam = 1.0
        for _ in range(max_backtracks):
            trial = residual(x + lam * dx)
            tnorm = np.linalg.norm(trial)
            if tnorm < (1.0 - 1e-4 * lam) * fnorm:
                break
            lam *= 0.5
        x = x + lam * dx
        F = residual(x)
        it += 1
        history.append((float(np.linalg.norm(F)), lam))
    rn = float(np.linalg.norm(F))
    return HostNewtonResult(x, it, rn, rn <= tol, history)
