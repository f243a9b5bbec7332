#!/usr/bin/env python3
"""Where the time of the port's channel solve goes, on one NVIDIA card.

    python3 profile_torch_solve.py [--lc 0.04] [--out chiprun_out/profile]

Runs ``flow.channel.solve_ns_flow(10, circle, 0.5, lc)`` three times in
one process on ``cuda`` in float64:

1. cold (the first solve: it pays the K1 build and first-use costs);
2. warm, unprofiled: the wall time a user sees;
3. warm, under ``torch.profiler`` with one range per layer
   (``jacobian``, ``residual``, ``mg_setup``, ``fgmres``, ``mg_apply``
   inside ``fgmres``), wrapped around the package's functions here and
   nowhere in the package.

It prints each solve's wall and phase timings, the profiled run's host
time and device span per range, its device busy share (the union of
the kernels' device intervals over the profiled wall, both from that
one run) and the kernels with the most device time, and writes the
full tables to ``--out``.  The last line is one JSON summary.  Exits
nonzero without a CUDA card.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RE, RATIO = 10.0, 0.5
RANGES = ("jacobian", "residual", "mg_setup", "fgmres", "mg_apply")


def _ranged(name, fn):
    import torch

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return wrapped


def instrument():
    """Wrap the solve's layers in profiler ranges (module attributes the
    drivers look up at call time)."""
    import torch

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (
        driver, mg, newton)

    driver.matrix_values_layered = _ranged("jacobian",
                                           driver.matrix_values_layered)
    driver.residual_layered = _ranged("residual", driver.residual_layered)
    newton.fgmres = _ranged("fgmres", newton.fgmres)
    driver.fgmres = _ranged("fgmres", driver.fgmres)
    make_mg_pc = mg.make_mg_pc

    def make_ranged_pc(*args, **kw):
        with torch.profiler.record_function("mg_setup"):
            apply = make_mg_pc(*args, **kw)
        return _ranged("mg_apply", apply)
    mg.make_mg_pc = make_ranged_pc


def busy_us(events) -> float:
    """Length of the union of the device kernels' time intervals (us);
    the device side of the layer ranges spans idle gaps and is left out."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name not in RANGES)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lc", type=float, default=0.04)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile"))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("profile_torch_solve: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        solve_ns_flow)
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
        layered_spmv.reset_launches()
        t0 = time.perf_counter()
        sol = solve_ns_flow(RE, img, RATIO, channel_mesh_size=args.lc,
                            coarse_lc=args.lc, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not sol.converged:
            raise RuntimeError(f"{label} solve did not converge")
        print(f"{label}: wall {wall:.3f} s, timings "
              f"{json.dumps({k: round(v, 4) for k, v in sol.timings.items()})}"
              f", K1 launches {layered_spmv.LAUNCHES}", flush=True)
        return wall, sol

    cold, _ = solve("cold")
    warm, _ = solve("warm")
    instrument()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        prof_wall, _ = solve("profiled")
    events = prof.events()
    busy = busy_us(events) / 1e6
    avg = prof.key_averages()
    by_name = {e.key: e for e in avg if e.device_type == DeviceType.CPU}
    # host: the range's wall on the host; device span: first to last
    # kernel of the range on the device, idle gaps included
    ranges = {n: dict(calls=0, host_s=0.0, device_span_s=0.0)
              for n in RANGES}
    for e in events:
        if e.name in RANGES:
            r = ranges[e.name]
            if e.device_type == DeviceType.CPU:
                r["calls"] += 1
                r["host_s"] += e.cpu_time_total / 1e6
            else:
                r["device_span_s"] += (e.time_range.end
                                       - e.time_range.start) / 1e6
    for n, r in ranges.items():
        print(f"range {n}: {r['calls']} calls, host {r['host_s']:.3f} s, "
              f"device span {r['device_span_s']:.3f} s", flush=True)
    dev_attr = ("self_device_time_total" if hasattr(avg[0],
                "self_device_time_total") else "self_cuda_time_total")
    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA
                   and e.key not in RANGES),
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
    summary = dict(device=smi, lc=args.lc, cold_s=cold, warm_s=warm,
                   profiled_s=prof_wall, device_busy_s=busy,
                   busy_share_profiled=busy / prof_wall, ranges=ranges,
                   op_counts=n_ops)
    print(f"device busy {busy:.3f} s of the profiled {prof_wall:.3f} s "
          f"wall: {100 * busy / prof_wall:.1f}%", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
