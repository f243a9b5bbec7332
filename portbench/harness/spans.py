"""Spans recorded from outside the program, and the reduction of one
profiled case.

``Spans.install`` wraps functions of the port's modules (module
attributes that the callers look up at call time, as
``profile_torch_solve.py`` does; nothing in the package is edited).
Each wrapper adds its call's host time to ``host_s[name]``, and while
``profiling`` is set it also logs the call's interval on the clock of
the profiler's trace (``time.time_ns``), so that the idle gaps of a
profiled case can be told by what the host was doing.  A call nested in
a call of the same name is counted once.  ``captured`` keeps the last
return value of the wrappers that capture one (the inlet profiles,
which the reference needs).

``reduce_profile`` turns the device events of one profiled case (the
profiler's raw events, CUDA activity only) into the device's busy time
(the union of the operations' intervals, the ``busy_us`` of
``profile_torch_solve.py``), device time by operation name and the
idle gaps by host range.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import importlib
import time
from typing import Dict, List, Tuple

PKG = "stabilized_navier_stokes_flow_fenicsx_tpu_torch"

# range name -> (module of the port, attribute) wrapped in that module
WRAPPED: Dict[str, List[Tuple[str, str]]] = {
    "solve": [("apps.inlet_batch", "solve_ns_flow")],
    "inlet_profiles": [("flow.channel", "solve_inlet_profiles")],
    "mesh": [("flow.channel", "generate_channel_mesh")],
    "layered_setup": [("flow.channel", "_setup_layered")],
    "interpolate": [("flow.channel", "interpolate_solution")],
    "jacobian": [("solve.driver", "matrix_values_layered")],
    "residual": [("solve.driver", "residual_layered")],
    "fgmres": [("solve.driver", "fgmres"), ("solve.newton", "fgmres")],
    "metadata": [("apps.inlet_batch", "write_run_metadata")],
    "checkpoint_write": [("apps.inlet_batch", "save_navier_stokes_solution")],
    "checkpoint_read": [("apps.inlet_batch", "read_xdmf_function"),
                        ("apps.streamtrace_cli", "read_xdmf_function")],
    "seed_profiles": [("apps.inlet_batch", "solve_inlet_profiles"),
                      ("apps.streamtrace_cli", "solve_inlet_profiles")],
    "trace": [("apps.inlet_batch", "for_and_rev_streamtrace"),
              ("apps.streamtrace_cli", "for_and_rev_streamtrace")],
    "contour": [("trace.pipeline", "update_contour")],
    "locator": [("trace.pipeline", "build_trace_locator")],
    "rk45": [("trace.pipeline", "trace_particles")],
    "alpha_shape": [("trace.pipeline", "alpha_shape_polygon")],
    "outlet_mask": [("trace.pipeline", "points_in_polygon")],
    "figures": [("apps.inlet_batch", "save_trace_figures"),
                ("apps.streamtrace_cli", "save_trace_figures")],
}
CAPTURED = ("inlet_profiles", "seed_profiles")
# the V-cycle: make_mg_pc is "mg_setup", the apply it returns "vcycle"
MG = ("solve.mg", "make_mg_pc")


class Spans:
    def __init__(self):
        self.host_s: Dict[str, float] = collections.defaultdict(float)
        self.captured: Dict[str, object] = {}
        self.profiling = False
        self.intervals: List[Tuple[str, int, int]] = []
        self._depth: Dict[str, int] = collections.defaultdict(int)
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, name: str, fn):
        capture = name in CAPTURED

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if self._depth[name]:
                return fn(*args, **kw)
            self._depth[name] += 1
            t0 = time.perf_counter()
            n0 = time.time_ns()
            try:
                out = fn(*args, **kw)
            finally:
                self.host_s[name] += time.perf_counter() - t0
                if self.profiling:
                    self.intervals.append((name, n0, time.time_ns()))
                self._depth[name] -= 1
            if capture:
                self.captured[name] = out
            return out
        return wrapped

    def _patch(self, module: str, attr: str, new) -> None:
        mod = importlib.import_module(f"{PKG}.{module}")
        self._undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    def install(self) -> "Spans":
        for name, sites in WRAPPED.items():
            for module, attr in sites:
                mod = importlib.import_module(f"{PKG}.{module}")
                self._patch(module, attr, self.wrap(name, getattr(mod, attr)))
        mg = importlib.import_module(f"{PKG}.{MG[0]}")
        make = self.wrap("mg_setup", getattr(mg, MG[1]))

        def make_mg_pc(*args, **kw):
            return self.wrap("vcycle", make(*args, **kw))
        self._patch(*MG, make_mg_pc)
        return self

    def uninstall(self) -> None:
        while self._undo:
            mod, attr, old = self._undo.pop()
            setattr(mod, attr, old)

    def snapshot(self) -> Dict[str, float]:
        return dict(self.host_s)


def delta(after: Dict[str, float], before: Dict[str, float]
          ) -> Dict[str, float]:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0) > 0.0}


@dataclasses.dataclass
class Profile:
    """One profiled case, reduced."""

    window_s: float                      # the case's host wall
    busy_s: float                        # union of device operations
    kernel_s: Dict[str, float]           # device time by operation name
    idle_by_range: Dict[str, float]      # idle gaps by innermost range


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_profile(events, intervals: List[Tuple[str, int, int]],
                   t0_ns: int, t1_ns: int) -> Profile:
    """Reduce the raw device events of one case that ran from ``t0_ns``
    to ``t1_ns`` (``time.time_ns``, the trace's clock).  The time before
    the first and after the last device operation is idle too."""
    import numpy as np
    from torch.autograd import DeviceType

    kern: List[Tuple[int, int]] = []
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        s, d = e.start_ns(), e.duration_ns()
        kern.append((s, s + d))
        kernel_s[e.name()] += d / 1e9
    busy = _union(kern)
    busy_s = sum(t - s for s, t in busy) / 1e9
    gaps, cur = [], t0_ns
    for s, t in busy:
        if s > cur:
            gaps.append((cur, min(s, t1_ns)))
        cur = max(cur, t)
    if t1_ns > cur:
        gaps.append((cur, t1_ns))
    gaps = [(s, t) for s, t in gaps if t > s]
    # innermost range at a gap's midpoint: ranges from the longest to
    # the shortest each claim the gaps they cover, so the shortest wins
    names = ["harness"]
    owner = np.zeros(len(gaps), dtype=np.int64)
    mids = np.array([0.5 * (s + t) for s, t in gaps])
    for name, rs, re_ in sorted(intervals, key=lambda r: r[1] - r[2]):
        a, b = np.searchsorted(mids, [rs, re_], side="left")
        if b > a:
            if name not in names:
                names.append(name)
            owner[a:b] = names.index(name)
    length = np.array([(t - s) / 1e9 for s, t in gaps])
    idle = {n: float(length[owner == i].sum()) for i, n in enumerate(names)
            if (owner == i).any()}
    return Profile((t1_ns - t0_ns) / 1e9, busy_s, dict(kernel_s),
                   idle)
