#!/usr/bin/env python3
"""K1 (the layered SpMV) on one NVIDIA card: its launch shapes, and
optionally an earlier version of it, at the lc=0.04 channel's shapes.

    python3 profile_torch_k1.py [--old DIR] [--out build/profile_k1]

On the V-cycle levels of the lc=0.04 channel at the stored solution's
state (``tests/torch_kernel_bounds.py::k1_levels``), for the five
(values, x) type pairs on the levels where the solves launch each
(``solve_levels``):

1. ``--old DIR``: an earlier K1, given as a directory that holds its
   ``assemble/layered_spmv.py`` (with ``layered_matvec_cuda(values, x,
   cols, row_ptr, n2d)`` on canonical (4, 4, 3, E, Lp) values) and its
   ``csrc/layered_spmv.cu``; it is built and loaded from there.  The
   earlier and the current kernel are timed in turns (old, new, new,
   old), L2 flushed and back to back, unmasked and masked; the earlier
   kernel's masked form is what its callers ran, ``m * K1(m * x) +
   (1 - m) * x``.  Then the host time per call at the coarsest level:
   1,000 calls, one synchronize, host clock, for each.
2. The current kernel at level 0 at each block size ``BLOCK_THREADS`` of
   64, 128, 256 and 512 and each value load width ``VEC_BYTES`` of 8 and
   16 (the launch shape the wrapper derives from them), L2 flushed and
   back to back, unmasked and masked.

First, the timing's floor: a one-element ``fill_`` timed as K1 is, L2
flushed.  Every line names the card (nvidia-smi name and power limit).  Writes
``--out``/k1.json; the last line is one JSON summary.  Exits nonzero
without a CUDA card.  Imports no JAX.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
BLOCKS = (64, 256)
VEC_BYTES = (2, 4, 8, 16)


def load_old(directory: str):
    """The earlier K1 wrapper module from ``directory``."""
    path = os.path.join(directory, "assemble", "layered_spmv.py")
    spec = importlib.util.spec_from_file_location("k1_old", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
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
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_k1"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_k1: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_kernel_bounds as kb
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv as new)
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
    if old is not None:
        old.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    print("\n".join(line for line in nvcc.LOGS.get("layered_spmv", "")
                    .splitlines()
                    if "ptxas" in line and ("registers" in line
                                            or "spill" in line)),
          flush=True)
    os.makedirs(args.out, exist_ok=True)
    img = make_annulus_image(os.path.join(args.out, "circle.png"), "circle")
    device = torch.device("cuda")
    levels = kb.k1_levels(torch, np, img, device)
    flush = kb.L2Flush(torch, device)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal(op.mask.numel()),
                          device=device) for op in levels]
    on_levels = kb.solve_levels(len(levels))
    rows = []
    one = torch.zeros(1, device=device)
    floor = kb.time_flushed_ms(lambda: one.fill_(1.0), flush)
    print(json.dumps({"floor_ms": floor, "what": "one-element fill_, L2 "
                      "flushed: the timing's floor", "card": smi}),
          flush=True)

    def record(**kw):
        kw["card"] = smi
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    for vname, xname in on_levels:
        vdt, xdt = getattr(torch, vname), getattr(torch, xname)
        for k in on_levels[(vname, xname)]:
            op = levels[k]
            xt = xs[k].to(xdt)
            mk = op.mask.to(xdt)
            for masked in (False, True):
                bound, _ = kb.k1_bound(op, vdt, xdt, masked)
                base = dict(pair=f"{vname}/{xname}", level=k,
                            Lp=op.n_planes, masked=masked, bound_ms=bound)
                K = new.LayeredOperand(op.values, op.cols, op.row_ptr,
                                       op.n2d, mask=mk if masked else None,
                                       dtype=vdt)
                fns = {"new": lambda: K(xt)}
                if old is not None:
                    v_old = op.values.to(vdt).contiguous()
                    if masked:       # what the earlier callers ran
                        def old_fn(v=v_old, op=op, xt=xt, mk=mk):
                            return mk * old.layered_matvec_cuda(
                                v, mk * xt, op.cols, op.row_ptr, op.n2d) \
                                + (1.0 - mk) * xt
                    else:
                        def old_fn(v=v_old, op=op, xt=xt):
                            return old.layered_matvec_cuda(
                                v, xt, op.cols, op.row_ptr, op.n2d)
                    fns["old"] = old_fn
                    diff = float((fns["old"]().double()
                                  - fns["new"]().double()).abs().max())
                    base["max_abs_old_vs_new"] = diff
                order = ["old", "new", "new", "old"] if old else ["new"]
                times = {name: [] for name in fns}
                b2b = {name: [] for name in fns}
                for name in order:
                    times[name].append(kb.time_flushed_ms(fns[name],
                                                          flush))
                    b2b[name].append(kb.time_b2b_ms(fns[name]))
                for name in fns:
                    record(**base, kernel=name, ms=times[name],
                           ms_b2b=b2b[name],
                           share_of_bound=bound / statistics.median(
                               times[name]))
                if k == len(levels) - 1 and masked:
                    for name in order[:2] if old else order:
                        record(pair=f"{vname}/{xname}", level=k,
                               masked=True, kernel=name,
                               host_us_per_call=host_us(torch, fns[name]))
    # launch shapes of the current kernel at level 0
    for vname, xname in on_levels:
        vdt, xdt = getattr(torch, vname), getattr(torch, xname)
        block0 = new.BLOCK_THREADS, new.VEC_BYTES
        op, xt = levels[0], xs[0].to(xdt)
        for masked in (False, True):
            bound, _ = kb.k1_bound(op, vdt, xdt, masked)
            for threads in BLOCKS:
                for vec in VEC_BYTES:
                    new.BLOCK_THREADS, new.VEC_BYTES = threads, vec
                    K = new.LayeredOperand(
                        op.values, op.cols, op.row_ptr, op.n2d,
                        mask=op.mask if masked else None, dtype=vdt)
                    ms = kb.time_flushed_ms(lambda: K(xt), flush)
                    record(pair=f"{vname}/{xname}", level=0, masked=masked,
                           kernel="new", block_threads=threads,
                           vec_bytes=vec,
                           launch_shape=new.launch_shape(K.Lp_pad, vdt, xdt),
                           ms=ms, ms_b2b=kb.time_b2b_ms(lambda: K(xt)),
                           share_of_bound=bound / ms)
            new.BLOCK_THREADS, new.VEC_BYTES = block0
    with open(os.path.join(args.out, "k1.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps({"card": smi, "rows": len(rows), "floor_ms": floor}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
