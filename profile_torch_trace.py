#!/usr/bin/env python3
"""Where the time of the port's streamtrace goes, on one NVIDIA card.

    python3 profile_torch_trace.py [--out build/profile_trace]

Traces the stored lc=0.04 Re=10 field (tests/fixtures/channel_ns_prod.npz)
with ``trace.pipeline.for_and_rev_streamtrace(200, ...)`` three times
in one process on ``cuda`` in float64: cold, warm, and warm under
``torch.profiler`` inside a ``case`` span of the program's tracer.
Prints each run's wall and its ``stats``, the profiled run's device
busy share (the union of the kernels' device intervals over the
profiled wall, both from that one run), its program spans with their
host time, the card's idle time they hold and their host reads
(``profile_torch_solve.py::span_table``), the kernel launches of the
profiled run and how many of them were K3's (the RK45 kernel, one per
direction) and the kernels with the most device time; writes the full
tables to ``--out``.  The last line is one JSON summary.  Exits nonzero
without a CUDA card.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RATIO, LC = 0.5, 0.04
NUM_SEEDS = 200            # reverse grid per side (InletBatchScript.py:41)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "profile_trace"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("profile_torch_trace: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from profile_torch_solve import busy_us, span_table
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace.pipeline import (
        for_and_rev_streamtrace)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (
        streamtrace)
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
    mesh, _, _ = generate_channel_mesh(img, LC, DEFAULT)
    w = np.load(os.path.join(ROOT, "tests", "fixtures",
                             "channel_ns_prod.npz"))["w"]
    u, _ = make_mixed_space(mesh, 1, 1).split(w)
    seeds = solve_inlet_profiles(img, RATIO, DEFAULT)[0].mesh.points
    dev = torch.device("cuda")

    def trace(label):
        t0 = time.perf_counter()
        res = for_and_rev_streamtrace(NUM_SEEDS, img, mesh, u, seeds,
                                      DEFAULT, device=dev)
        wall = time.perf_counter() - t0
        print(f"{label}: wall {wall:.3f} s, outlet points "
              f"{len(res.outlet_points)}, stats {json.dumps(res.stats)}",
              flush=True)
        return wall, res.stats

    cold, _ = trace("cold")
    warm, stats = trace("warm")
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    streamtrace.reset_launches()
    with torch.profiler.profile(activities=act) as prof:
        with profiling.span("case"):
            prof_wall, _ = trace("profiled")
    k3_launches = streamtrace.LAUNCHES
    events = prof.events()
    busy = busy_us(events) / 1e6
    spans = span_table(prof, profiling.cases()[-1])
    n_kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    avg = prof.key_averages()
    dev_attr = ("self_device_time_total" if hasattr(avg[0],
                "self_device_time_total") else "self_cuda_time_total")
    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                  key=lambda e: -getattr(e, dev_attr))
    print("kernels with the most device time:", flush=True)
    for e in kern[:12]:
        print(f"  {getattr(e, dev_attr) / 1e3:10.3f} ms  {e.count:7d}x  "
              f"{e.key[:90]}", flush=True)
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(smi + "\n")
        f.write(avg.table(sort_by=dev_attr, row_limit=60))
        f.write("\n")
        f.write(avg.table(sort_by="cpu_time_total", row_limit=60))
    summary = dict(device=smi, seeds=NUM_SEEDS, cold_s=cold, warm_s=warm,
                   warm_fwd_s=stats["fwd_s"], warm_rev_s=stats["rev_s"],
                   profiled_s=prof_wall, device_busy_s=busy,
                   busy_share_profiled=busy / prof_wall,
                   kernel_launches=n_kernels, k3_launches=k3_launches,
                   **spans)
    print(f"device busy {busy:.3f} s of the profiled {prof_wall:.3f} s "
          f"wall: {100 * busy / prof_wall:.1f}%; {n_kernels} kernel "
          f"launches, {k3_launches} of them K3's", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
