#!/usr/bin/env python3
"""Where the time of the port's channel solve goes, on one NVIDIA card.

    python3 profile_torch_solve.py [--lc 0.04] [--coarse-lc LC] [--out DIR]

Runs ``flow.channel.solve_ns_flow(10, circle, 0.5, lc)`` three times in
one process on ``cuda`` in float64, on one mesh, or through the coarse
pass at ``--coarse-lc`` and the interpolation (the apps' route at 0.1):

1. cold (the first solve: it pays the K1 build and first-use costs);
2. warm, unprofiled: the wall time a user sees;
3. warm, under ``torch.profiler``, inside a ``case`` span of the
   program's tracer (``utils/profiling.py``).

It prints each solve's wall and phase timings, the profiled run's
device busy share (the union of the kernels' device intervals over the
profiled wall, both from that one run), then for each of the program's
spans its calls, inclusive and self host time, the card's idle time
while it is the innermost open span (the spans and the kernels share
``time.time_ns``) and its blocking device->host reads
(``host_reads``), and the kernels with the most device time, and writes
the full tables to ``--out``.  The last line is one JSON summary.
Exits nonzero without a CUDA card.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RE, RATIO = 10.0, 0.5


def busy_us(events) -> float:
    """Length of the union of the device kernels' time intervals (us)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def innermost(spans) -> list:
    """Disjoint (t0_ns, t1_ns, name) pieces: at each instant the
    innermost of ``spans`` (the tracer's tuples, properly nested) that
    is open then, so that each span's pieces add up to its self time."""
    pieces, stack, cur = [], [], None
    for _, _, _, name, s0, s1 in sorted(spans, key=lambda s: (s[4], -s[5])):
        while stack and stack[-1][1] <= s0:
            top, end = stack.pop()
            if end > cur:
                pieces.append((cur, end, top))
                cur = end
        if stack and s0 > cur:
            pieces.append((cur, s0, stack[-1][0]))
        cur = s0
        stack.append((name, s1))
    while stack:
        top, end = stack.pop()
        if end > cur:
            pieces.append((cur, end, top))
            cur = end
    return pieces


def idle_by_span(prof, case) -> dict:
    """The card's idle time over ``case`` (a ``profiling.Case``) split by
    the innermost program span open at each instant of each gap:
    {name: seconds}."""
    from torch.autograd import DeviceType

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import (
        profiling)

    busy = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    gaps, cur = [], case.t0_ns
    for s, t in busy:
        if s > cur:
            gaps.append((cur, min(s, case.t1_ns)))
        cur = max(cur, t)
    if case.t1_ns > cur:
        gaps.append((cur, case.t1_ns))
    pieces = innermost(s for s in profiling.spans() if s[2] == case.id)
    idle = collections.defaultdict(float)
    i = 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            p0, p1, name = pieces[j]
            if min(g1, p1) > max(g0, p0):
                idle[name] += (min(g1, p1) - max(g0, p0)) / 1e9
            j += 1
    return dict(idle)


def span_table(prof, case) -> dict:
    """Print and return, for each program span of ``case``: calls,
    inclusive and self host seconds, the card's idle seconds it holds
    and its ``host_reads``."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import (
        profiling)

    calls = collections.Counter(s[3] for s in profiling.spans()
                                if s[2] == case.id)
    idle = idle_by_span(prof, case)
    reads = case.counters.get("host_reads", {})
    rows = {n: dict(calls=calls[n], inclusive_s=case.inclusive_s[n],
                    self_s=case.self_s[n], idle_s=idle.get(n, 0.0),
                    host_reads=reads.get(n, 0))
            for n in case.inclusive_s}
    print(f"{'span':<20} {'calls':>6} {'incl s':>9} {'self s':>9} "
          f"{'idle s':>9} {'reads':>7}", flush=True)
    for n, r in sorted(rows.items(), key=lambda kv: -kv[1]["idle_s"]):
        print(f"{n:<20} {r['calls']:>6} {r['inclusive_s']:>9.3f} "
              f"{r['self_s']:>9.3f} {r['idle_s']:>9.3f} "
              f"{r['host_reads']:>7}", flush=True)
    counters = {k: sum(v.values()) for k, v in case.counters.items()}
    print(f"counters: {json.dumps(counters)}", flush=True)
    return dict(spans=rows, counters=counters)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lc", type=float, default=0.04)
    ap.add_argument("--coarse-lc", type=float, default=None,
                    help="the coarse pass's lc (default: --lc, one mesh)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile"))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("profile_torch_solve: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        solve_ns_flow)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import (
        profiling)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
        make_annulus_image)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    os.makedirs(args.out, exist_ok=True)
    img = make_annulus_image(os.path.join(args.out, "circle.png"), "circle")
    dev = torch.device("cuda")

    def solve(label):
        since = profiling.counts("k1_launch")
        t0 = time.perf_counter()
        sol = solve_ns_flow(RE, img, RATIO, channel_mesh_size=args.lc,
                            coarse_lc=args.coarse_lc or args.lc,
                            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not sol.converged:
            raise RuntimeError(f"{label} solve did not converge")
        print(f"{label}: wall {wall:.3f} s, timings "
              f"{json.dumps({k: round(v, 4) for k, v in sol.timings.items()})}"
              f", K1 launches "
              f"{sum(profiling.counts('k1_launch', since).values())}",
              flush=True)
        return wall, sol

    cold, _ = solve("cold")
    warm, _ = solve("warm")
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        with profiling.span("case"):
            prof_wall, _ = solve("profiled")
    events = prof.events()
    busy = busy_us(events) / 1e6
    avg = prof.key_averages()
    by_name = {e.key: e for e in avg if e.device_type == DeviceType.CPU}
    spans = span_table(prof, profiling.cases()[-1])
    dev_attr = ("self_device_time_total" if hasattr(avg[0],
                "self_device_time_total") else "self_cuda_time_total")
    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                  key=lambda e: -getattr(e, dev_attr))
    print("kernels with the most device time:", flush=True)
    for e in kern[:12]:
        print(f"  {getattr(e, dev_attr) / 1e3:10.3f} ms  {e.count:7d}x  "
              f"{e.key[:90]}", flush=True)
    n_ops = {k: by_name[k].count for k in ("aten::mul", "aten::add",
                                           "aten::index_add_")
             if k in by_name}
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(smi + "\n")
        f.write(avg.table(sort_by=dev_attr, row_limit=60))
        f.write("\n")
        f.write(avg.table(sort_by="cpu_time_total", row_limit=60))
    summary = dict(device=smi, lc=args.lc, coarse_lc=args.coarse_lc,
                   cold_s=cold, warm_s=warm,
                   profiled_s=prof_wall, device_busy_s=busy,
                   busy_share_profiled=busy / prof_wall, **spans,
                   op_counts=n_ops)
    print(f"device busy {busy:.3f} s of the profiled {prof_wall:.3f} s "
          f"wall: {100 * busy / prof_wall:.1f}%", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
