"""Krylov solvers: CG, BiCGStab, TFQMR, FGMRES and MINRES.

Counterparts of the JAX package's ``solve/krylov.py``.  The vectors live
on the device; the scalar recurrences (step lengths, Givens rotations,
convergence tests) run on the host in float64, with one device->host
read of the inner products each step needs (where the JAX loops test
their flags on the device; each read counts as one ``host_reads``,
utils/profiling.py).  FGMRES and TFQMR record a span per solve and
count their iterations (``krylov_its``).  Every method keeps the JAX
arithmetic order and stopping rules, so iteration counts agree to the
last bits of the inner products.

Under ranks (parallel/): ``cg``, ``tfqmr`` and ``fgmres`` take
``reduce``, a function that sums a tensor over the ranks (each rank holds
a slice of every vector).  Partial dot products and squared norms are
stacked, reduced once and then read.  With ``reduce=None`` (the default)
no such call is made and the operations are those of a single process.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import count, read, span


@dataclasses.dataclass
class KrylovResult:
    x: torch.Tensor
    iters: int             # iterations (TFQMR: matvecs) performed
    resnorm: float         # final residual norm (see each method)
    converged: bool


def _ident(x):
    return x


def _traced(method):
    """Record each call of ``method`` as a span of its name and count its
    iterations as ``krylov_its`` under that name."""
    @functools.wraps(method)
    def traced(*args, **kw):
        with span(method.__name__):
            res = method(*args, **kw)
        count("krylov_its", res.iters, method.__name__)
        return res
    return traced


def _norm_t(v: torch.Tensor, reduce=None) -> torch.Tensor:
    """|v| as a 0-d tensor; under ranks the root of the summed squares."""
    if reduce is None:
        return torch.linalg.vector_norm(v)
    return torch.sqrt(reduce(torch.dot(v, v)))


def _norm(v: torch.Tensor, reduce=None) -> float:
    return read(_norm_t(v, reduce))


def _dot(a: torch.Tensor, b: torch.Tensor, reduce=None) -> torch.Tensor:
    """a . b as a 0-d tensor, summed over the ranks under ``reduce``."""
    d = torch.dot(a, b)
    return d if reduce is None else reduce(d)


def _reads(*scalars: torch.Tensor):
    """Several 0-d tensors to Python floats with one device->host read."""
    return read(torch.stack(scalars), torch.Tensor.tolist)


def _norm_and_dot(v, a, b, reduce=None):
    """(|v|, a . b) as floats with one device->host read and, under
    ranks, one reduction of the stacked partial sums."""
    if reduce is None:
        return _reads(torch.linalg.vector_norm(v), torch.dot(a, b))
    vv, ab = read(reduce(torch.stack([torch.dot(v, v), torch.dot(a, b)])),
                  torch.Tensor.tolist)
    return math.sqrt(vv), ab


def _div(a: float, b: float) -> float:
    """a / b with IEEE semantics (inf or nan at b == 0), as the device
    arithmetic of the JAX loops gives it."""
    try:
        return a / b
    except ZeroDivisionError:
        if a == 0.0 or math.isnan(a):
            return math.nan
        return math.copysign(math.inf, a) * math.copysign(1.0, b)


def cg(A, b, x0=None, M=None, rtol=1e-10, atol=0.0, max_it=10000,
       reduce=None) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD systems); stops when
    |r| <= max(rtol |b|, atol) (the recursive residual)."""
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = M(r)
    p = z
    tol = max(rtol * _norm(b, reduce), atol)
    rn, rz = _norm_and_dot(r, r, z, reduce)
    it = 0
    while rn > tol and it < max_it:
        Ap = A(p)
        alpha = _div(rz, read(_dot(p, Ap, reduce)))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rn, rz_new = _norm_and_dot(r, r, z, reduce)
        p = z + _div(rz_new, rz) * p
        rz = rz_new
        it += 1
    return KrylovResult(x, it, rn, rn <= tol)


def bicgstab(A, b, x0=None, M=None, rtol=1e-10, atol=0.0, max_it=10000
             ) -> KrylovResult:
    """Right-preconditioned BiCGStab; stops on |r| <= max(rtol |b|, atol)
    or a breakdown (|rho| or |omega| below 1e-300)."""
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    tol = max(rtol * _norm(b), atol)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = 1.0
    it, brk = 0, False
    rn, rho_new = _reads(torch.linalg.vector_norm(r), torch.dot(rhat, r))
    while rn > tol and it < max_it and not brk:
        beta = _div(rho_new, rho) * _div(alpha, omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = _div(rho_new, read(torch.dot(rhat, v)))
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        tt, ts = _reads(torch.dot(t, t), torch.dot(t, s))
        omega = ts / tt if tt > 0 else 0.0
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        brk = abs(rho) < 1e-300 or abs(omega) < 1e-300
        it += 1
        rn, rho_new = _reads(torch.linalg.vector_norm(r), torch.dot(rhat, r))
    return KrylovResult(x, it, rn, rn <= tol)


@_traced
def tfqmr(A, b, x0=None, M=None, rtol=1e-10, atol=0.0, max_it=10000,
          reduce=None) -> KrylovResult:
    """Right-preconditioned transpose-free QMR (Freund 1993).

    The reference's Newton Krylov: PETSc ``ksp_type tfqmr`` + ASM
    (NavierStokes/NavierStokesChannelFlow.py:198-202).  Each loop pass is
    a HALF-step with one operator and one preconditioner apply, so
    ``max_it`` and ``iters`` count matvecs, as PETSc does.  The parity of
    the half-step picks its branch on the host: an even half-step forms
    the new step length, an odd one the new search direction.

    Stops on the quasi-residual bound ``tau * sqrt(it + 1) <= max(rtol
    |b|, atol)`` (what ``converged`` reports) or a breakdown (|sigma| or
    |rho| below 1e-30).  ``resnorm`` is the TRUE residual |b - A x|,
    computed once after the loop.
    """
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - A(x)
    tol = max(rtol * _norm(b, reduce), atol)
    rstar = r0
    w = u = r0
    Mu = M(r0)
    Bu = A(Mu)
    v = Bu
    d = torch.zeros_like(b)
    tau, rho = _norm_and_dot(r0, r0, r0, reduce)
    theta = eta = sigma = 0.0
    alpha = 1.0
    tiny = 1e-30
    it, brk = 0, False
    while tau * math.sqrt(it + 1) > tol and it < max_it and not brk:
        even = it % 2 == 0
        if even:
            # v is unchanged over the odd half-step that follows, so its
            # sigma serves both halves
            sigma = read(_dot(rstar, v, reduce))
            alpha = _div(rho, sigma)
        w = w - alpha * Bu
        d = Mu + _div(theta * theta * eta, alpha) * d
        if even:
            wn = _norm(w, reduce)
        else:
            wn, rho_new = _norm_and_dot(w, rstar, w, reduce)
        theta = _div(wn, tau)
        c = 1.0 / math.sqrt(1.0 + theta * theta)
        tau = tau * theta * c
        eta = c * c * alpha
        x = x + eta * d
        if even:
            u = u - alpha * v
            Mu = M(u)
            Bu_prev, Bu = Bu, A(Mu)
        else:
            beta = _div(rho_new, rho)
            u = w + beta * u
            Mu = M(u)
            Bu_prev, Bu = Bu, A(Mu)
            v = Bu + beta * (Bu_prev + beta * v)
            rho = rho_new
        brk = abs(sigma) < tiny or abs(rho) < tiny
        it += 1
    converged = tau * math.sqrt(it + 1) <= tol
    return KrylovResult(x, it, _norm(b - A(x), reduce), converged)


@_traced
def fgmres(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 50,
    max_restarts: int = 40,
    reduce: Optional[Callable] = None,
) -> KrylovResult:
    """FGMRES(m): Arnoldi with modified Gram-Schmidt; the Z basis stores
    preconditioned vectors, so M may itself be an inner iteration.  Each
    restart cycle ends with an exact residual recompute, and the solve
    stops when |b - A x| <= max(rtol |b|, atol) or after
    ``max_restarts`` cycles; ``resnorm`` is that true residual.  Under
    ranks every Gram-Schmidt coefficient is reduced before it is
    subtracted (the orthogonalisation stays the modified one)."""
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    m = restart
    tol = max(rtol * _norm(b, reduce), atol)

    def arnoldi_cycle(x):
        r = b - A(x)
        beta = _norm(r, reduce)
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
                hij = _dot(V[i], w, reduce)
                w = w - hij * V[i]
                h.append(hij)
            hj1 = _norm_t(w, reduce)
            H[:j + 2, j] = read(torch.stack(h + [hj1]), torch.Tensor.tolist)
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

    rn = _norm(b - A(x), reduce)
    cycles = its = 0
    while rn > tol and cycles < max_restarts:
        x, steps = arnoldi_cycle(x)
        # exact residual recompute per cycle (the Givens estimate drifts
        # under a low-precision preconditioner)
        rn = _norm(b - A(x), reduce)
        cycles += 1
        its += steps
    return KrylovResult(x, its, rn, rn <= tol)


def minres(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    max_it: int = 10000,
) -> KrylovResult:
    """Preconditioned MINRES (Paige-Saunders) for symmetric indefinite A.

    M must be symmetric positive definite (e.g. the block-diagonal
    diag(diag(A_uu), M_p) preconditioner of the Taylor-Hood saddle
    point).  Stops when the recurrence's residual estimate phibar <=
    max(rtol beta1, atol), beta1 = sqrt(r0 . M r0); ``resnorm`` is that
    estimate.
    """
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else x0
    r1 = b - A(x)
    y = M(r1)
    beta1 = read(torch.dot(r1, y))
    beta1 = math.sqrt(beta1) if beta1 >= 0 else math.nan
    tol = max(rtol * beta1, atol)
    eps_t = torch.finfo(b.dtype).tiny
    r2 = r1
    w = w2 = torch.zeros_like(b)
    oldb, beta, dbar, epsln, phibar = 0.0, beta1, 0.0, 0.0, beta1
    cs, sn = -1.0, 0.0
    it = 0
    while phibar > tol and it < max_it:
        v = y / max(beta, eps_t)
        y2 = A(v)
        if it >= 1:
            y2 = y2 - (beta / max(oldb, eps_t)) * r1
        alfa = read(torch.dot(v, y2))
        y2 = y2 - (alfa / max(beta, eps_t)) * r2
        r1, r2 = r2, y2
        y = M(r2)
        oldb = beta
        beta = math.sqrt(max(read(torch.dot(r2, y)), 0.0))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = max(math.sqrt(gbar * gbar + beta * beta), eps_t)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        it += 1
    return KrylovResult(x, it, phibar, phibar <= tol)
