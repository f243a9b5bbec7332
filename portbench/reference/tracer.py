"""Particle tracing through a P1 velocity field on a tetrahedral mesh.

The semantics of the port's streamtrace (reference streamtrace.py:144-218,
357-383, as the port states them): Dormand-Prince RK45 per seed from
dt = max_step, the error as the RMS over the three components of
(x5 - x4) / (atol + rtol max(|x|, |x5|)), a step accepted at error <= 1,
the next step dt clip(0.9 err^-0.2, 0.2, 5) clipped to [1e-6, max_step]
and cut to the time left; terminal events: the speed at the step's start
under speed_eps, the plane x = x_stop crossed in the stop direction (the
crossing found by 16 bisections of the cubic Hermite interpolant through
the step's ends, and the endpoint taken on it), and t_max; at most
max_steps steps.  Outside the mesh the velocity is zero.

Written from those rules alone, in plain PyTorch: a uniform bucket grid
locates the points, each lane is one seed, and only the lanes still
running are stepped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_A = [[], [1 / 5], [3 / 40, 9 / 40], [44 / 45, -56 / 15, 32 / 9],
      [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
      [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
      [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]]
_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
       187 / 2100, 1 / 40]


@dataclasses.dataclass(frozen=True)
class TraceParams:
    t_max: float
    max_step: float
    speed_eps: float
    rtol: float
    atol: float
    max_steps: int


class Field:
    """The P1 velocity u (n, 3) on (points, cells), located by a grid of
    buckets about two cells each."""

    def __init__(self, points, cells, u, dtype=torch.float64, device="cpu",
                 tol: float = 1e-6):
        P = torch.as_tensor(np.asarray(points), dtype=dtype, device=device)
        C = torch.as_tensor(np.asarray(cells), dtype=torch.int64,
                            device=device)
        self.u = torch.as_tensor(np.asarray(u), dtype=dtype, device=device)
        self.cells, self.tol = C, tol
        X = P[C]                                            # (nc, 4, 3)
        self.x0 = X[:, 0]
        # barycentric map: lam_123 = T (q - x0)
        self.T = torch.linalg.inv((X[:, 1:] - X[:, :1]).transpose(1, 2))
        lo, hi = X.amin(1), X.amax(1)
        self.lo = P.amin(0)
        span = P.amax(0) - self.lo
        h = float((span.prod() / max(1, C.shape[0] // 2)) ** (1 / 3))
        self.h = h
        self.dims = torch.clamp((span / h).floor().long() + 1, min=1)
        i0 = ((lo - self.lo) / h).floor().long().clamp(min=0)
        i1 = torch.minimum(((hi - self.lo) / h).floor().long(), self.dims - 1)
        ext = i1 - i0 + 1                                   # (nc, 3)
        cnt = ext.prod(1)
        cell = torch.repeat_interleave(torch.arange(C.shape[0], device=device),
                                       cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(int(cnt.sum()), device=device) - first[cell]
        e = ext[cell]
        off = torch.stack([k // (e[:, 1] * e[:, 2]),
                           (k // e[:, 2]) % e[:, 1], k % e[:, 2]], 1)
        ijk = i0[cell] + off
        bucket = self._bucket(ijk)
        order = torch.argsort(bucket)
        self.bucket_cells = cell[order]
        nb = int(self.dims.prod())
        counts = torch.bincount(bucket, minlength=nb)
        self.start = torch.cumsum(counts, 0) - counts
        self.count = counts
        self.kmax = int(counts.max())

    def _bucket(self, ijk):
        d = self.dims
        return (ijk[:, 0] * d[1] + ijk[:, 1]) * d[2] + ijk[:, 2]

    def velocity(self, q: torch.Tensor) -> torch.Tensor:
        ijk = ((q - self.lo) / self.h).floor().long()
        ok = ((ijk >= 0) & (ijk < self.dims)).all(1)
        b = self._bucket(torch.minimum(ijk.clamp(min=0), self.dims - 1))
        n = self.count[b] * ok                               # (m,)
        kk = torch.arange(self.kmax, device=q.device)
        valid = kk[None, :] < n[:, None]
        slot = (self.start[b][:, None] + kk[None, :]).clamp(
            max=self.bucket_cells.shape[0] - 1)
        cand = self.bucket_cells[slot]                       # (m, K)
        d = q[:, None, :] - self.x0[cand]
        l123 = torch.einsum("mkij,mkj->mki", self.T[cand], d)
        lam = torch.cat([1.0 - l123.sum(-1, keepdim=True), l123], -1)
        inside = (lam >= -self.tol).all(-1) & valid
        hit = inside.any(1)
        j = inside.to(torch.int8).argmax(1)
        rows = torch.arange(q.shape[0], device=q.device)
        c = cand[rows, j]
        v = (lam[rows, j][:, :, None] * self.u[self.cells[c]]).sum(1)
        return torch.where(hit[:, None], v, 0.0)


def trace(field: Field, seeds, sign: float, x_stop: float, stop_dir: float,
          prm: TraceParams) -> torch.Tensor:
    """Endpoints (n, 3) of the seeds traced through sign * u."""
    dt_ = field.u.dtype
    dev = field.u.device
    x = torch.as_tensor(np.asarray(seeds), dtype=dt_, device=dev).clone()
    n = x.shape[0]

    def f(q):
        return sign * field.velocity(q)

    v = f(x)
    t = torch.zeros(n, dtype=dt_, device=dev)
    dt = torch.full((n,), prm.max_step, dtype=dt_, device=dev)
    steps = torch.zeros(n, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(prm.max_steps):
        idx = torch.nonzero(~done & (steps < prm.max_steps)).flatten()
        if idx.numel() == 0:
            break
        xa, va, ta, dta = x[idx], v[idx], t[idx], dt[idx]
        h = torch.minimum(dta, prm.t_max - ta)
        ks = [va]
        for i in range(1, 7):
            xi = xa.clone()
            for j, a in enumerate(_A[i]):
                if a != 0.0:
                    xi = xi + (h * a)[:, None] * ks[j]
            ks.append(f(xi))
        x5 = xa + h[:, None] * sum(b * k for b, k in zip(_B5, ks) if b)
        x4 = xa + h[:, None] * sum(b * k for b, k in zip(_B4, ks) if b)
        scale = prm.atol + prm.rtol * torch.maximum(xa.abs(), x5.abs())
        err = (((x5 - x4) / scale) ** 2).mean(1).sqrt()
        accept = err <= 1.0
        speed_stop = torch.linalg.vector_norm(va, dim=1) < prm.speed_eps
        g0 = (xa[:, 0] - x_stop) * stop_dir
        g1 = (x5[:, 0] - x_stop) * stop_dir
        hit = (g0 < 0) & (g1 >= 0) & accept
        v6 = ks[6]
        # the x component of the Hermite cubic, in powers of theta
        hv0, hv6 = h * va[:, 0], h * v6[:, 0]
        c1 = hv0 * stop_dir
        c2 = (3 * (x5[:, 0] - xa[:, 0]) - 2 * hv0 - hv6) * stop_dir
        c3 = (2 * (xa[:, 0] - x5[:, 0]) + hv0 + hv6) * stop_dir
        lo = torch.zeros_like(h)
        for k in range(1, 17):
            mid = lo + 2.0 ** -k
            gm = ((c3 * mid + c2) * mid + c1) * mid + g0
            lo = torch.where(gm < 0, mid, lo)
        frac = torch.where(hit, lo + 2.0 ** -16, 1.0)[:, None]
        th2, th3 = frac * frac, frac * frac * frac
        herm = ((2 * th3 - 3 * th2 + 1) * xa + (th3 - 2 * th2 + frac)
                * h[:, None] * va + (-2 * th3 + 3 * th2) * x5
                + (th3 - th2) * h[:, None] * v6)
        x_acc = torch.where(hit[:, None], herm, x5)
        t_new = torch.where(accept, ta + h * frac[:, 0], ta)
        fac = (0.9 * err ** -0.2).clamp(0.2, 5.0)
        finished = speed_stop | hit | (t_new >= prm.t_max - 1e-12)
        x[idx] = torch.where(accept[:, None], x_acc, xa)
        v[idx] = torch.where(accept[:, None], v6, va)
        t[idx] = t_new
        dt[idx] = (dta * fac).clamp(1e-6, prm.max_step)
        done[idx] = (accept & finished) | speed_stop
        steps[idx] += 1
    return x
