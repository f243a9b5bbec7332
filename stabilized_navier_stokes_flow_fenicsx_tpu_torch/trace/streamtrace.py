"""Batched RK45 particle tracing with terminal events.

Counterpart of the JAX package's ``trace/streamtrace.py``, replacing the
reference's per-seed scipy ``solve_ivp`` calls (reference
NavierStokes/streamtrace.py:198-218, 357-383): ALL seeds integrate
together as one batched Dormand-Prince RK45 with per-seed adaptive steps
and masked terminal events:

  * speed < 1e-6            (terminal; particle stalled at a wall)
  * x crosses 3.7 forward / 0.13 backward (plane events, :183 :188)

Velocity lookup is the packed-row locator (fem/interpolate.py) + a
barycentric P1 eval from a per-cell packed value row; points outside the
domain get zero velocity exactly like ``velfunc`` (:144-157).  Event
times are refined by bisection of the free FSAL Hermite interpolant.

The JAX package runs each seed as its own ``while_loop`` under ``vmap``.
Here a segment is a loop of masked steps over the whole batch: in every
iteration each lane whose condition (not done, fewer than ``max_steps``
steps) holds takes one step, and every other lane keeps its state.  Lanes
are independent, so this is exact.  A segment runs its ``seg_steps``
iterations without reading anything back; the host reads one scalar per
segment (the not-done count of the compaction).  Counters (``steps``,
``seed_id``, ``lane_steps``) are 64-bit.  Each round of segments is the
span ``rk45.round``; rounds and segment calls are counted
(``trace_rounds``, ``trace_dispatches``) and the host reads
(``host_reads``, utils/profiling.py).

FSAL carry: DP45's 7th stage IS the next step's first stage, and a
rejected step restarts from the same x, so stage 0 is never re-evaluated
— 6 velocity evals per step instead of 7.

On the card with the layered locator, ``trace_particles`` runs K3
instead (``trace_k3``, ``csrc/streamtrace.cu``): one hand-written CUDA
kernel launch per ``chunk`` of seeds, one thread per seed, each lane
integrating to its end with the per-lane semantics of ``trace_segment``
(it replaces no TPU kernel; the source says what bounds it and what its
design does about that).  There is no fallback from the kernel: on CUDA
tensors with a ``LayeredDeviceLocator`` the trace launches K3 or raises.
``trace_particles_plain`` (``trace_segment`` under the compacted rounds)
is its twin, and runs for CPU tensors and for the general
``DeviceLocator``.  The kernel is built at first use with ``nvcc`` into
``build/torch_kernels/`` (utils/nvcc.py), and takes the tableau, the
bisection count, the step controller's constants and the locator's
tolerance from this module and fem/interpolate.py.  Each launch adds one
to the tracer's counter ``k3_launch`` under its shape (lanes, Lp, K2,
dtype, direction).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..fem.interpolate import LOCATE_TOL, LayeredDeviceLocator, locate_any
from ..utils import nvcc
from ..utils.profiling import count, dtype_name, read, span

# Dormand-Prince RK45 tableau
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0])
_B4 = np.array([5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
                187 / 2100, 1 / 40])
# event bisection iterations on the Hermite interpolant (frac to 2^-16)
_N_BISECT = 16
# the step controller: factor _SAFETY * err ** _EXPONENT clamped to
# [_FAC_MIN, _FAC_MAX], the step to [_DT_MIN, max_step]; a lane finishes
# at t >= t_max - _T_EPS
_SAFETY, _EXPONENT = 0.9, -0.2
_FAC_MIN, _FAC_MAX = 0.2, 5.0
_DT_MIN = 1e-6
_T_EPS = 1e-12
# masked RK iterations per segment of trace_particles (one host read each)
SEG_STEPS = 128


@dataclasses.dataclass(frozen=True)
class TraceConfigDevice:
    """Trace parameters (plain floats; the forward and reverse traces
    differ only in these)."""

    t_max: float = 20.0
    max_step: float = 0.125
    speed_eps: float = 1e-6
    x_stop: float = 3.7           # plane event
    stop_direction: int = 1       # +1: trigger when x rises past plane
    rtol: float = 1e-6
    atol: float = 1e-8
    max_steps: int = 4096
    sign: float = 1.0             # velocity sign: -1.0 = reverse trace


def pack_u_cells(dloc, u_nodes: torch.Tensor) -> torch.Tensor:
    """Per-cell packed nodal values (nc, nv*3): ONE row gather per
    velocity eval instead of nv scattered node-row gathers."""
    nc = dloc.cells.shape[0]
    return u_nodes[dloc.cells].reshape(nc, -1)


def _velocity(dloc, u_cell: torch.Tensor, x: torch.Tensor,
              sign: float) -> torch.Tensor:
    """Velocity at the points x (n, 3); zero outside the domain (velfunc
    semantics)."""
    cell, bary = locate_any(dloc, x)
    nv = bary.shape[1]
    nodal = u_cell[cell.clamp_min(0)].view(-1, nv, 3)      # (n, nv, 3)
    v = (bary[:, :, None] * nodal).sum(dim=1)
    return torch.where((cell >= 0)[:, None], sign * v, 0.0)


@dataclasses.dataclass
class TraceState:
    """Per-seed integration state (resumable across segments)."""

    x: torch.Tensor        # (n, 3)
    v: torch.Tensor        # (n, 3) FSAL carry: f(x) at the current x
    t: torch.Tensor        # (n,)
    dt: torch.Tensor       # (n,)
    done: torch.Tensor     # (n,) bool
    steps: torch.Tensor    # (n,) int64


def init_trace_state(seeds, cfg: TraceConfigDevice, dloc,
                     u_cell: torch.Tensor) -> TraceState:
    """Fresh state on u_cell's device; the FSAL carry ``v`` is a
    placeholder — trace_segment computes f(x) for lanes with steps == 0."""
    dtype, device = u_cell.dtype, u_cell.device
    x = torch.as_tensor(seeds, dtype=dtype, device=device)
    n = x.shape[0]
    return TraceState(
        x=x,
        v=torch.zeros((n, 3), dtype=dtype, device=device),
        t=torch.zeros(n, dtype=dtype, device=device),
        dt=torch.full((n,), cfg.max_step, dtype=dtype, device=device),
        done=torch.zeros(n, dtype=torch.bool, device=device),
        steps=torch.zeros(n, dtype=torch.int64, device=device),
    )


def _rk_step(f, x, dt, v0, B, atol, rtol):
    """One FSAL DP45 step from x with step dt (n,): (x5, err (n,), the
    seven stages (7, n, 3)).  B is the (2, 7) tensor [_B5; _B4]."""
    ks = [v0]
    for i in range(1, 7):
        xi = x
        for j in range(i):
            if _A[i, j] != 0.0:
                xi = xi + (dt * float(_A[i, j]))[:, None] * ks[j]
        ks.append(f(xi))
    K = torch.stack(ks)                                     # (7, n, 3)
    x5, x4 = x + dt[:, None] * torch.einsum("bk,knc->bnc", B, K)
    scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
    err = ((((x5 - x4) / scale) ** 2).mean(dim=1)).sqrt()
    return x5, err, K


def _hermite(theta, x, h, v0, x_new, v6):
    """The FSAL cubic Hermite interpolant through (x, v0) -> (x_new, v6)
    at theta (n, 1), in the JAX package's term order."""
    t2 = theta * theta
    t3 = t2 * theta
    return ((2 * t3 - 3 * t2 + 1) * x
            + (t3 - 2 * t2 + theta) * h * v0
            + (-2 * t3 + 3 * t2) * x_new
            + (t3 - t2) * h * v6)


def trace_segment(cfg: TraceConfigDevice, dloc, u_cell: torch.Tensor,
                  state: TraceState, seg_steps: int = 256) -> TraceState:
    """Advance all seeds by at most seg_steps RK45 steps (the JAX
    package's ``trace_segment`` and its body ``_segment_core``).

    Runs exactly seg_steps masked iterations and reads nothing back to
    the host.
    """
    sign = float(cfg.sign)
    B = torch.as_tensor(np.stack([_B5, _B4]), dtype=u_cell.dtype,
                        device=u_cell.device)
    plane = cfg.x_stop
    sdir = float(cfg.stop_direction)

    def f(x):
        return _velocity(dloc, u_cell, x, sign)

    x, t, dt, done, steps = (state.x, state.t, state.dt, state.done,
                             state.steps)
    # FSAL seed init: a lane with steps == 0 has never evaluated its
    # carry, so compute f(x) for it here (one velocity eval per segment)
    v = torch.where((steps == 0)[:, None], f(x), state.v)
    for _ in range(seg_steps):
        active = (~done) & (steps < cfg.max_steps)
        h = torch.minimum(dt, cfg.t_max - t)                # dt_eff
        x_new, err, K = _rk_step(f, x, h, v, B, cfg.atol, cfg.rtol)
        accept = err <= 1.0
        speed_stop = torch.linalg.vector_norm(v, dim=1) < cfg.speed_eps
        g0 = (x[:, 0] - plane) * sdir
        g1 = (x_new[:, 0] - plane) * sdir
        hit = (g0 < 0) & (g1 >= 0) & accept
        # event refinement on the FREE dense interpolant: DP45 is FSAL
        # (K[6] = f(x_new)), so a cubic Hermite through (x, v) ->
        # (x_new, K[6]) needs zero extra velocity evals.  Bisect the
        # event function in its power form on every lane (no
        # data-dependent selection, so no host sync).
        v6 = K[6]
        hv0, hv6 = h * v[:, 0], h * v6[:, 0]
        c0 = g0
        c1 = hv0 * sdir
        c2 = (3 * (x_new[:, 0] - x[:, 0]) - 2 * hv0 - hv6) * sdir
        c3 = (2 * (x[:, 0] - x_new[:, 0]) + hv0 + hv6) * sdir
        # lo and hi = lo + 2^-k are exact dyadic rationals, so the
        # midpoint is lo + 2^-(k+1) exactly
        lo = torch.zeros_like(h)
        for k in range(1, _N_BISECT + 1):
            mid = lo + 2.0 ** -k
            gm = ((c3 * mid + c2) * mid + c1) * mid + c0
            lo = torch.where(gm < 0, mid, lo)
        frac = torch.where(hit, lo + 2.0 ** -_N_BISECT, 1.0)
        x_acc = torch.where(
            hit[:, None],
            _hermite(frac[:, None], x, h[:, None], v, x_new, v6), x_new)
        t_new = torch.where(accept, t + h * frac, t)
        x_out = torch.where(accept[:, None], x_acc, x)
        # FSAL carry: an accepted step's K[6] IS f(x_new); a rejected
        # step restarts from the same x, so v still holds.  (On an event
        # hit x_out is the Hermite endpoint, not x_new — but that lane is
        # done and its carry is never read again.)
        v_out = torch.where(accept[:, None], v6, v)
        fac = (_SAFETY * err ** _EXPONENT).clamp(_FAC_MIN, _FAC_MAX)
        dt_new = (dt * fac).clamp(_DT_MIN, cfg.max_step)
        finished = speed_stop | hit | (t_new >= cfg.t_max - _T_EPS)
        done_new = done | (accept & finished) | speed_stop
        # lanes whose condition is false keep their state
        x = torch.where(active[:, None], x_out, x)
        v = torch.where(active[:, None], v_out, v)
        t = torch.where(active, t_new, t)
        dt = torch.where(active, dt_new, dt)
        done = torch.where(active, done_new, done)
        steps = steps + active
    return TraceState(x, v, t, dt, done, steps)


@dataclasses.dataclass
class FullTraceState:
    """Whole-grid state of the compacted tracer, kept on the device
    between segments: the host reads ONE scalar per round (the not-done
    count) and the endpoints once at the end."""

    x: torch.Tensor         # (N, 3)
    v: torch.Tensor         # (N, 3) FSAL carry
    t: torch.Tensor         # (N,)
    dt: torch.Tensor        # (N,)
    done: torch.Tensor      # (N,) bool
    steps: torch.Tensor     # (N,) int64
    seed_id: torch.Tensor   # (N,) int64 original seed index
    lane_steps: int = 0     # lane-iterations the segments executed


_STATE_FIELDS = ("x", "v", "t", "dt", "done", "steps")
_LANE_FIELDS = _STATE_FIELDS + ("seed_id",)


def _init_full_state(x0: torch.Tensor, max_step: float) -> FullTraceState:
    """Whole-grid state on x0's device (the FSAL carry ``v`` is a
    placeholder, as in init_trace_state)."""
    N, dtype, device = x0.shape[0], x0.dtype, x0.device
    return FullTraceState(
        x=x0,
        v=torch.zeros((N, 3), dtype=dtype, device=device),
        t=torch.zeros(N, dtype=dtype, device=device),
        dt=torch.full((N,), max_step, dtype=dtype, device=device),
        done=torch.zeros(N, dtype=torch.bool, device=device),
        steps=torch.zeros(N, dtype=torch.int64, device=device),
        seed_id=torch.arange(N, dtype=torch.int64, device=device),
    )


def _finalize_full_state(st: FullTraceState):
    """(endpoints unpermuted to seed order, accepted-step count as a
    0-d int64 tensor)."""
    ends = torch.empty_like(st.x)
    ends[st.seed_id] = st.x
    return ends, st.steps.sum()


def _compact_state(st: FullTraceState):
    """Pack not-done lanes to the front (stable) and return the count
    (a 0-d tensor).

    argsort of the done flags is a stable partition: active lanes keep
    their relative order (the JAX package's order)."""
    order = torch.argsort(st.done.to(torch.uint8), stable=True)
    packed = FullTraceState(*(getattr(st, k)[order] for k in _LANE_FIELDS),
                            lane_steps=st.lane_steps)
    return packed, (~st.done).sum()


def _trace_compacted(cfg: TraceConfigDevice, dloc, u_cell: torch.Tensor,
                     x0: torch.Tensor, chunk: int,
                     seg_steps: int) -> Tuple[FullTraceState, int]:
    """The compacted rounds of ``trace_particles_plain``: (the final
    whole-grid state (lanes permuted; ``seed_id`` maps them back), the
    segment calls made)."""
    st = _init_full_state(x0, cfg.max_step)
    calls = 0
    for _ in range(-(-int(cfg.max_steps) // seg_steps)):
        with span("rk45.round"):
            st, n_active = _compact_state(st)
            na = read(n_active, int)      # the ONLY per-round host read
            if na == 0:
                break
            count("trace_rounds")
            for offset in range(0, na, chunk):
                st = _run_chunk(cfg, dloc, u_cell, st,
                                min(chunk, na - offset), offset, seg_steps)
                count("trace_dispatches")
                calls += 1
    return st, calls


def _run_chunk(cfg: TraceConfigDevice, dloc, u_cell: torch.Tensor,
               st: FullTraceState, chunk: int, offset: int,
               seg_steps: int) -> FullTraceState:
    """Advance lanes [offset, offset+chunk) by one segment and write them
    back into st (in place); returns st."""
    sl = slice(offset, offset + chunk)
    out = trace_segment(
        cfg, dloc, u_cell,
        TraceState(*(getattr(st, k)[sl] for k in _STATE_FIELDS)), seg_steps)
    for k in _STATE_FIELDS:
        getattr(st, k)[sl] = getattr(out, k)
    st.lane_steps += chunk * seg_steps
    return st


def trace_particles(
    cfg: TraceConfigDevice,
    dloc,
    u_nodes: torch.Tensor,
    seeds,                          # (n, 3)
    reverse: bool = False,
    chunk: int = 0,
    seg_steps: int = SEG_STEPS,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Integrate all seeds; returns endpoints (n, 3) on the locator's
    device.

    reverse=True negates the field (velfunc_reverese, :159-173).

    With a ``LayeredDeviceLocator`` on the card the seeds run through K3
    (``trace_k3``), ``chunk`` lanes a launch (all of them for chunk=0),
    each launch the span ``rk45.round`` and one ``trace_rounds`` and
    ``trace_dispatches``; ``seg_steps`` is not used.  Otherwise (CPU
    tensors, the general locator) through ``trace_particles_plain``.

    stats (optional dict) accumulates: seeds, dispatches (K3 launches or
    segment calls), lane_steps (lane-iterations executed: the plain
    version's masked ones included; under K3, which runs none, equal to
    seed_steps) and seed_steps (accepted + rejected RK steps summed over
    seeds).
    """
    if isinstance(dloc, LayeredDeviceLocator) and dloc.cells.is_cuda:
        return _trace_particles_k3(cfg, dloc, u_nodes, seeds, reverse,
                                   chunk, stats)
    return trace_particles_plain(cfg, dloc, u_nodes, seeds, reverse, chunk,
                                 seg_steps, stats)


def _stats_keys(stats: Optional[dict]) -> None:
    if stats is not None:
        for k in ("seeds", "dispatches", "lane_steps", "seed_steps"):
            stats.setdefault(k, 0)


def _trace_particles_k3(cfg: TraceConfigDevice, dloc: LayeredDeviceLocator,
                        u_nodes, seeds, reverse: bool, chunk: int,
                        stats: Optional[dict]) -> torch.Tensor:
    """``trace_particles`` through K3."""
    if reverse:
        cfg = dataclasses.replace(cfg, sign=-1.0)
    u_cell = pack_u_cells(dloc, torch.as_tensor(u_nodes,
                                                device=dloc.cells.device))
    x0 = torch.as_tensor(seeds, dtype=u_cell.dtype, device=u_cell.device)
    _stats_keys(stats)
    n = x0.shape[0]
    width = chunk or max(n, 1)
    ends, steps = [], []
    for offset in range(0, n, width):
        with span("rk45.round"):
            count("trace_rounds")
            count("trace_dispatches")
            x, st, _ = trace_k3(cfg, dloc, u_cell, x0[offset:offset + width])
        ends.append(x)
        steps.append(st)
    if stats is not None:
        seed_steps = read(torch.cat(steps).sum(), int) if n else 0
        stats["seeds"] += n
        stats["dispatches"] += len(ends)
        stats["seed_steps"] += seed_steps
        stats["lane_steps"] += seed_steps
    return torch.cat(ends) if n else torch.empty_like(x0)


def trace_particles_plain(
    cfg: TraceConfigDevice,
    dloc,
    u_nodes: torch.Tensor,
    seeds,                          # (n, 3)
    reverse: bool = False,
    chunk: int = 0,
    seg_steps: int = SEG_STEPS,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """The plain version of ``trace_particles`` (K3's twin), on any
    device and locator: masked ``trace_segment`` iterations.

    chunk > 0 enables the COMPACTED tracer (the product path for big seed
    grids): between seg_steps segments the not-done seeds are packed to
    the front by a stable partition, and only they are traced, ``chunk``
    lanes per segment call at most (the last call of a round is
    narrower; nothing is padded).  Finished lanes and wall-stalled
    stragglers then stop costing work after their segment.
    """
    if reverse:
        cfg = dataclasses.replace(cfg, sign=-1.0)
    u_nodes = torch.as_tensor(u_nodes, device=dloc.cells.device)
    u_cell = pack_u_cells(dloc, u_nodes)
    _stats_keys(stats)
    if not chunk:
        state = init_trace_state(seeds, cfg, dloc, u_cell)
        n = state.x.shape[0]
        for _ in range(-(-int(cfg.max_steps) // seg_steps)):
            with span("rk45.round"):
                count("trace_rounds")
                count("trace_dispatches")
                state = trace_segment(cfg, dloc, u_cell, state, seg_steps)
                if stats is not None:
                    stats["dispatches"] += 1
                    stats["lane_steps"] += n * seg_steps
                if read(state.done.all(), bool):
                    break
        if stats is not None:
            stats["seeds"] += n
            stats["seed_steps"] += read(state.steps.sum(), int)
        return state.x

    st, calls = _trace_compacted(
        cfg, dloc, u_cell,
        torch.as_tensor(seeds, dtype=u_cell.dtype, device=u_cell.device),
        chunk, seg_steps)
    ends, seed_steps = _finalize_full_state(st)
    if stats is not None:
        stats["seeds"] += st.x.shape[0]
        stats["dispatches"] += calls
        stats["seed_steps"] += read(seed_steps, int)
        stats["lane_steps"] += st.lane_steps
    return ends


# ---- K3: the hand-written kernel -------------------------------------------

COUNTER = "k3_launch"
_DTYPE = {torch.float64: 0, torch.float32: 1}
SMEM_LIMIT = 49152        # the planes' shared memory (no opt-in above it)
_LIB: Optional[ctypes.CDLL] = None

_D7 = ctypes.c_double * 7


class _Params(ctypes.Structure):
    """The kernel's ``Params``: the locator's tables, the packed field
    and the trace's parameters."""
    _fields_ = [("x_planes", ctypes.c_void_p), ("lo2", ctypes.c_void_p),
                ("inv_h2", ctypes.c_void_p), ("tab2", ctypes.c_void_p),
                ("prism_base", ctypes.c_void_p),
                ("prism_geom", ctypes.c_void_p), ("u_cell", ctypes.c_void_p),
                ("Lp", ctypes.c_int), ("nl", ctypes.c_int),
                ("K2", ctypes.c_int), ("s0", ctypes.c_int),
                ("s1", ctypes.c_int), ("n_bisect", ctypes.c_int),
                ("max_steps", ctypes.c_longlong)] + [
        (k, ctypes.c_double) for k in (
            "t_max", "t_end", "max_step", "speed_eps", "x_stop",
            "direction", "rtol", "atol", "sign", "tol", "safety",
            "exponent", "fac_min", "fac_max", "dt_min")] + [
        ("a", _D7 * 7), ("b5", _D7), ("b4", _D7)]


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = nvcc.kernel("streamtrace")
        vp = ctypes.c_void_p
        lib.streamtrace.restype = ctypes.c_int
        lib.streamtrace.argtypes = [vp, vp, vp, vp, ctypes.c_int,
                                    ctypes.c_int, vp,
                                    ctypes.POINTER(_Params)]
        lib.streamtrace_chase.restype = ctypes.c_int
        lib.streamtrace_chase.argtypes = [vp, ctypes.c_longlong, vp, vp]
        _LIB = lib
    return _LIB


def kernel_params(cfg: TraceConfigDevice, dloc: LayeredDeviceLocator,
                  u_cell: torch.Tensor) -> _Params:
    """The launch's ``Params``: the tables' addresses and shapes, and the
    constants of ``trace_segment`` and the locator."""
    return _Params(
        dloc.x_planes.data_ptr(), dloc.lo2.data_ptr(),
        dloc.inv_h2.data_ptr(), dloc.tab2.data_ptr(),
        dloc.prism_base.data_ptr(), dloc.prism_geom.data_ptr(),
        u_cell.data_ptr(), dloc.x_planes.shape[0], dloc.nl,
        dloc.tab2.shape[1], dloc.shape2[0], dloc.shape2[1], _N_BISECT,
        int(cfg.max_steps), cfg.t_max, cfg.t_max - _T_EPS, cfg.max_step,
        cfg.speed_eps, cfg.x_stop, float(cfg.stop_direction), cfg.rtol,
        cfg.atol, float(cfg.sign), LOCATE_TOL, _SAFETY, _EXPONENT,
        _FAC_MIN, _FAC_MAX, _DT_MIN,
        (_D7 * 7)(*(_D7(*row) for row in _A)), _D7(*_B5), _D7(*_B4))


def _check_k3(dloc: LayeredDeviceLocator, u_cell: torch.Tensor,
              seeds: torch.Tensor) -> None:
    """Raise unless every tensor K3 reads is contiguous, on one CUDA
    device, of one floating dtype K3 takes (int64 ``prism_base``), and
    shaped as the kernel reads it."""
    dtype, dev = seeds.dtype, seeds.device
    if dtype not in _DTYPE:
        raise ValueError(f"streamtrace: K3 takes float64 or float32 seeds, "
                         f"got {dtype}")
    named = [("seeds", seeds), ("u_cell", u_cell),
             ("x_planes", dloc.x_planes), ("lo2", dloc.lo2),
             ("inv_h2", dloc.inv_h2), ("tab2", dloc.tab2),
             ("prism_geom", dloc.prism_geom),
             ("prism_base", dloc.prism_base)]
    for name, t in named:
        want = torch.int64 if name == "prism_base" else dtype
        if t.dtype != want or t.device != dev:
            raise ValueError(f"streamtrace: {name} is {t.dtype} on "
                             f"{t.device}, K3 needs {want} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"streamtrace: {name} is not contiguous")
    Lp = dloc.x_planes.shape[0]
    if seeds.dim() != 2 or seeds.shape[1] != 3 \
            or tuple(u_cell.shape[1:]) != (12,) \
            or dloc.tab2.dim() != 3 or dloc.tab2.shape[2] != 7 \
            or tuple(dloc.prism_geom.shape[1:]) != (36,) \
            or dloc.nl != Lp - 1 \
            or Lp * seeds.element_size() > SMEM_LIMIT:
        raise ValueError(
            f"streamtrace: K3 takes seeds (n, 3), u_cell (nc, 12), tab2 "
            f"(n_bins, K2, 7), prism_geom (n, 36) and at most "
            f"{SMEM_LIMIT // seeds.element_size()} planes; got "
            f"{tuple(seeds.shape)}, {tuple(u_cell.shape)}, "
            f"{tuple(dloc.tab2.shape)}, {tuple(dloc.prism_geom.shape)}, "
            f"{Lp} planes")
    if dev.type != "cuda":
        raise ValueError(f"streamtrace: K3 runs on a CUDA card; the tensors "
                         f"are on {dev}")


def trace_k3(cfg: TraceConfigDevice, dloc: LayeredDeviceLocator,
             u_cell: torch.Tensor, seeds: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: one launch integrating every seed (n, 3) from a fresh state
    (t = 0, dt = max_step) until it is done or has taken
    ``cfg.max_steps`` steps, as ``trace_segment`` integrates a lane.
    u_cell: ``pack_u_cells``'s rows, with ``cfg.sign`` the direction.
    Returns (endpoints (n, 3), steps (n,) int64, done (n,) bool) in seed
    order, on the seeds' stream, without a host read.  Raises on a
    tensor K3 does not take (``_check_k3``) and on a failed launch."""
    _check_k3(dloc, u_cell, seeds)
    n = seeds.shape[0]
    x = torch.empty_like(seeds)
    steps = torch.zeros(n, dtype=torch.int64, device=seeds.device)
    done = torch.zeros(n, dtype=torch.bool, device=seeds.device)
    if n == 0:
        return x, steps, done
    fn = build().streamtrace
    P = kernel_params(cfg, dloc, u_cell)
    with torch.cuda.device(seeds.device):
        err = fn(seeds.data_ptr(), x.data_ptr(), steps.data_ptr(),
                 done.data_ptr(), n, _DTYPE[seeds.dtype],
                 torch.cuda.current_stream().cuda_stream, ctypes.byref(P))
    if err != 0:
        raise RuntimeError(f"streamtrace: K3 launch failed (cudaError "
                           f"{err})")
    count(COUNTER, key=(n, dloc.x_planes.shape[0], dloc.tab2.shape[1],
                        dtype_name(seeds.dtype),
                        "reverse" if cfg.sign < 0 else "forward"))
    return x, steps, done


def chase(next_idx: torch.Tensor, n_loads: int) -> torch.Tensor:
    """``streamtrace_chase``: one thread following ``n_loads`` dependent
    loads through the int64 chain ``next_idx`` (a CUDA tensor); returns
    the 0-d index it ends on.  Time it to read the latency of one load."""
    if next_idx.dtype != torch.int64 or not next_idx.is_cuda \
            or not next_idx.is_contiguous():
        raise ValueError("streamtrace: chase takes a contiguous int64 CUDA "
                         "tensor")
    out = torch.empty((), dtype=torch.int64, device=next_idx.device)
    with torch.cuda.device(next_idx.device):
        err = build().streamtrace_chase(
            next_idx.data_ptr(), int(n_loads), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"streamtrace: chase launch failed (cudaError "
                           f"{err})")
    return out
