#!/usr/bin/env python3
"""K2 (the plane Gauss-Seidel sweep) on one NVIDIA card: its launch plans,
and optionally an earlier version of it, at the lc=0.04 channel's shapes.

    python3 profile_torch_k2.py [--old DIR] [--out build/profile_k2]

On the smoothed V-cycle levels 0-2 of the lc=0.04 channel at the Stokes
matrix J(0) (``chip_smoke.k2_levels``), for the type pairs (f64 values,
f64 iterate) and (bf16 values, f32 iterate), the symmetric sweep with two
inner passes (what ``pc="mg"`` and ``"mg_bf16"`` run):

1. ``--old DIR``: an earlier K2, given as a directory that holds its
   ``solve/plane_gs.py`` (with ``PlaneGSOperand(values, cols, row_ptr,
   diag_pos, mask, n2d, dtype=)``) and its ``csrc/plane_gs.cu``; it is
   built and loaded from there.  The earlier and the current kernel are
   timed in turns (old, new, new, old), L2 flushed and back to back, with
   the largest difference of their results.
2. The current kernel at every cluster size of 1, 2, 4, 8 and 16 that
   fits and can be scheduled: L2 flushed, with its plan, its time per
   stage and the time of its cluster running the stage barriers alone.
3. The host time per call at level 2 (1,000 calls, one synchronize).

First, the timing's floor: a one-element ``fill_`` timed as K2 is, L2
flushed.  Every line names the card (nvidia-smi name and power limit).
Writes ``--out``/k2.json; the last line is one JSON summary.  Exits
nonzero without a CUDA card.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "stabilized_navier_stokes_flow_fenicsx_tpu_torch"
PAIRS = (("float64", "float64"), ("bfloat16", "float32"))


def load_old(directory: str):
    """The earlier K2 wrapper module from ``directory``, loaded inside the
    package (its relative imports resolve there), its kernel built from
    ``directory``/csrc."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import nvcc

    path = os.path.join(directory, "solve", "plane_gs.py")
    spec = importlib.util.spec_from_file_location(f"{PKG}.solve._k2_old",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    csrc = os.path.join(os.path.abspath(directory), "csrc")
    mod.nvcc = types.SimpleNamespace(
        build=lambda *names: nvcc.build(*names, csrc=csrc),
        kernel=lambda name: nvcc.build(name, csrc=csrc)[0])
    return mod


def host_us(torch, fn, n: int = 1000) -> float:
    """Host microseconds per call over n calls ended by one synchronize
    (after 10 warm-up calls)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_k2"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_k2: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (
        plane_gs as new)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import nvcc
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
        make_annulus_image)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    old = load_old(args.old) if args.old else None
    t0 = time.perf_counter()
    new.build()
    print("\n".join(line for line in nvcc.LOGS.get("plane_gs", "")
                    .splitlines() if "ptxas" in line), flush=True)
    if old is not None:
        old.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    os.makedirs(args.out, exist_ok=True)
    img = make_annulus_image(os.path.join(args.out, "circle.png"), "circle")
    device = torch.device("cuda")
    levels = cs.k2_levels(cs.k2_problem(torch, np, img, device),
                          "Stokes J(0)")[:-1]
    flush = cs.L2Flush(torch, device)
    rng = np.random.default_rng(0)
    rs = [torch.as_tensor(rng.standard_normal(op.mask.numel()),
                          device=device) for op in levels]
    rows = []
    one = torch.zeros(1, device=device)
    floor = cs.time_flushed_ms(lambda: one.fill_(1.0), flush)
    print(json.dumps({"floor_ms": floor, "what": "one-element fill_, L2 "
                      "flushed: the timing's floor", "card": smi}),
          flush=True)

    def record(**kw):
        kw["card"] = smi
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    for vname, aname in PAIRS:
        vdt = getattr(torch, vname)
        for k, op in enumerate(levels):
            r = rs[k]
            args_op = (op.values, op.cols, op.row_ptr, op.diag_pos, op.mask,
                       op.n2d)
            K = new.PlaneGSOperand(*args_op, dtype=vdt)
            bound, bound_by = cs.k2_bound(K)
            base = dict(pair=f"{vname}/{aname}", level=k,
                        shape=[K.E, K.Lp, K.n2d], stages=K.stages,
                        bound_ms=bound, bound_by=bound_by)
            fns = {"new": lambda K=K, r=r: K(r)}
            if old is not None:
                K_old = old.PlaneGSOperand(*args_op, dtype=vdt)
                fns["old"] = lambda K=K_old, r=r: K(r)
                base["max_abs_old_vs_new"] = float(
                    (fns["old"]() - fns["new"]()).abs().max())
            order = ["old", "new", "new", "old"] if old else ["new"]
            times = {name: [] for name in fns}
            b2b = {name: [] for name in fns}
            for name in order:
                times[name].append(cs.time_flushed_ms(fns[name], flush))
                b2b[name].append(cs.time_b2b_ms(fns[name], 20))
            for name in fns:
                record(**base, kernel=name, ms=times[name],
                       ms_b2b=b2b[name], share_of_bound=bound
                       / statistics.median(times[name]),
                       us_per_stage=statistics.median(times[name])
                       / K.stages * 1e3)
            # the launch plans of the current kernel
            for cluster in new.CLUSTER_SIZES:
                try:
                    Kc = new.PlaneGSOperand(*args_op, dtype=vdt,
                                            cluster=cluster)
                except (ValueError, RuntimeError) as e:
                    record(**base, kernel="new", cluster=cluster,
                           refused=str(e))
                    continue
                err = float((Kc(r) - new.plane_gs_plain(Kc, r)).abs().max())
                ms = cs.time_flushed_ms(lambda: Kc(r), flush)
                chain = cs.time_ms(Kc.barrier_chain, 10)
                p = Kc.plan
                record(**base, kernel="new", cluster=cluster, split=p.split,
                       threads=p.threads, slots=p.slots,
                       smem_bytes=p.smem_bytes, max_abs_vs_plain=err, ms=ms,
                       us_per_stage=ms / Kc.stages * 1e3,
                       barrier_chain_ms=chain,
                       automatic=p.cluster == K.plan.cluster)
            if k == len(levels) - 1:
                for name in order[:2] if old else order:
                    record(pair=f"{vname}/{aname}", level=k, kernel=name,
                           host_us_per_call=host_us(torch, fns[name]))
    with open(os.path.join(args.out, "k2.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps({"card": smi, "rows": len(rows), "floor_ms": floor}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
