#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and builds kernel K1
   (the layered SpMV, csrc/layered_spmv.cu) with nvcc into
   build/torch_kernels/;
2. assembles the lc=0.04 production channel (230,692 dofs) at the stored
   solution's state, with its multigrid hierarchy, and holds K1 against
   its plain PyTorch version for the three (values, x) type pairs the
   solve uses, on every V-cycle level where the solve launches each,
   timing both (CUDA events, median of 20);
3. runs the main path, ``flow.channel.solve_ns_flow(10, circle, 0.5,
   lc=0.04)`` in float64 on the card, and checks that it converged, that
   it matches tests/fixtures/channel_ns_prod.npz to rel-L2 < 1e-6, and
   that the solve launched K1;
4. prints one JSON line of kernel results (error: the largest over the
   levels checked; times: the fine level), then the final JSON status
   line.

Exits nonzero, with no result, without a CUDA card or without the
repository beside it.  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "stabilized_navier_stokes_flow_fenicsx_tpu_torch"
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "channel_ns_prod.npz")
RE, RATIO, LC = 10.0, 0.5, 0.04
TPU_KERNEL = ("stabilized_navier_stokes_flow_fenicsx_tpu/assemble/"
              "pallas_spmv.py:107")
# (values dtype, x dtype, rel-L2 tolerance of kernel vs plain):
# f64 differs only in summation order; with bf16 values the plain version
# rounds each product to bf16, the kernel takes it in the x dtype
PAIRS = (("float64", "float64", 1e-12),
         ("bfloat16", "float32", 5e-3),
         ("bfloat16", "float64", 5e-3))


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, n: int = 20) -> float:
    """Median milliseconds of ``fn`` over n timed calls (CUDA events),
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_kernels(torch, np, img, device):
    """Phase 2: K1 vs its plain version at the lc=0.04 shapes, on every
    V-cycle level where the solve launches each type pair."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        matrix_values_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        _setup_layered, generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.mg import (
        galerkin_levels)

    t0 = time.perf_counter()
    inlet1, inlet2 = solve_inlet_profiles(img, RATIO, DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, LC, DEFAULT)
    st = _setup_layered(mesh, inlet1, inlet2, torch.float64,
                        DEFAULT.solver.mg_levels, device)
    lp, a = st.lp, st.lp.arrays
    w_ref = np.load(FIXTURE)["w"]
    if w_ref.shape != (lp.ndofs,):
        raise RuntimeError(f"mesh has {lp.ndofs} dofs, fixture "
                           f"{w_ref.shape[0]}")
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / RE,
                               C_I=DEFAULT.stab.C_I)
    vals = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, a,
                                 torch.as_tensor(w_ref, device=device))
    levels = galerkin_levels(st.mg, vals, a.cols, a.row_ids, a.row_ptr,
                             a.diag_pos, st.mask, lp.n2d, lp.n_planes)
    torch.cuda.synchronize()
    print(f"K1 shapes: dofs {lp.ndofs}; (E, Lp, n2d) per V-cycle level "
          f"{[(op.values.shape[3], op.n_planes, op.n2d) for op in levels]}; "
          f"set-up {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal(op.mask.numel()),
                          device=device) for op in levels]
    # the levels each pair runs on in the solve: f64 is the outer
    # operator; bf16 values with f32 x are the smoothers and spectral
    # estimates on every level; with f64 x the residuals of every level
    # but the coarsest (solved densely)
    n_lv = len(levels)
    on_levels = {("float64", "float64"): range(1),
                 ("bfloat16", "float32"): range(n_lv),
                 ("bfloat16", "float64"): range(n_lv - 1)}
    results = []
    for vname, xname, tol in PAIRS:
        errs = []
        for k in on_levels[(vname, xname)]:
            op = levels[k]
            v = op.values.to(getattr(torch, vname)).contiguous()
            xt = xs[k].to(getattr(torch, xname))
            y_k = layered_spmv.layered_matvec_cuda(v, xt, op.cols,
                                                   op.row_ptr, op.n2d)
            torch.cuda.synchronize()
            y_p = layered_spmv.layered_matvec_plain(v, xt, op.cols,
                                                    op.row_ids, op.n2d)
            torch.cuda.synchronize()
            diff = (y_k.double() - y_p.double())
            max_abs = float(diff.abs().max())
            rel = float(torch.linalg.vector_norm(diff)
                        / torch.linalg.vector_norm(y_p.double()))
            if not torch.isfinite(y_k).all() or rel > tol:
                raise RuntimeError(
                    f"K1 ({vname} values, {xname} x) disagrees with its "
                    f"plain version on level {k}: rel-L2 {rel:.3e} > {tol:g}")
            ms = time_ms(lambda: layered_spmv.layered_matvec_cuda(
                v, xt, op.cols, op.row_ptr, op.n2d))
            plain_ms = time_ms(lambda: layered_spmv.layered_matvec_plain(
                v, xt, op.cols, op.row_ids, op.n2d))
            print(f"K1 ({vname} values, {xname} x) level {k}: rel-L2 "
                  f"{rel:.3e} (tol {tol:g}), max abs err {max_abs:.3e}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            errs.append(max_abs)
            if k == 0:
                times = (ms, plain_ms)
        results.append(dict(pair=(vname, xname), max_abs_err=max(errs),
                            ms=times[0], plain_ms=times[1]))
    return results


def run_main_path(torch, np, img, device):
    """Phase 3: the lc=0.04 continuation solve on the card."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        solve_ns_flow)

    layered_spmv.reset_launches()
    t0 = time.perf_counter()
    sol = solve_ns_flow(RE, img, RATIO, channel_mesh_size=LC, coarse_lc=LC,
                        device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(layered_spmv.LAUNCHES_BY_DTYPES)
    total = layered_spmv.LAUNCHES

    print(f"solve_ns_flow: {wall:.2f} s wall, timings "
          f"{json.dumps({k: round(v, 4) for k, v in sol.timings.items()})}",
          flush=True)
    print(f"Stokes FGMRES its {sol.stokes_iters}; fine Newton its "
          f"{sol.newton_iters}, |F| {sol.newton_resnorm:.3e}, converged "
          f"{sol.converged}", flush=True)
    for name, h in sol.newton_history.items():
        print(f"{name}: FGMRES its {[int(r[2]) for r in h]}, lambda "
              f"{[float(r[1]) for r in h]}, |F| "
              f"{[float('%.3e' % r[0]) for r in h]}", flush=True)
    by_pair = {f"{str(v).removeprefix('torch.')} values, "
               f"{str(x).removeprefix('torch.')} x": n
               for (v, x), n in launches.items()}
    print(f"K1 launches in the solve: {total} {by_pair}", flush=True)

    w_ref = np.load(FIXTURE)["w"]
    if not sol.converged:
        raise RuntimeError("the solve did not converge")
    if sol.w.shape != w_ref.shape:
        raise RuntimeError(f"dofs {sol.w.shape[0]} != fixture "
                           f"{w_ref.shape[0]}")
    if not np.isfinite(sol.w).all():
        raise RuntimeError("non-finite solution")
    rel = float(np.linalg.norm(sol.w - w_ref) / np.linalg.norm(w_ref))
    print(f"rel-L2 vs channel_ns_prod.npz: {rel:.3e} (bar 1e-6)", flush=True)
    if rel >= 1e-6:
        raise RuntimeError(f"solution rel-L2 {rel:.3e} >= 1e-6")
    if total <= 0:
        raise RuntimeError("the solve never launched K1")
    return launches


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        return fail(f"needs torch and numpy ({e})")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, PKG)) \
            or not os.path.exists(FIXTURE):
        return fail(f"run from a checkout of the repository ({PKG}/ and "
                    f"tests/fixtures/ beside this script)")
    sys.path.insert(0, ROOT)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
        make_annulus_image)

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {kind}",
          flush=True)

    t0 = time.perf_counter()
    layered_spmv.build()
    print(f"K1 build: {time.perf_counter() - t0:.2f} s", flush=True)
    print("\n".join(line for line in layered_spmv.BUILD_LOG.splitlines()
                    if "ptxas" in line), flush=True)

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    img = make_annulus_image(os.path.join(work, "circle.png"), "circle")

    try:
        checks = check_kernels(torch, np, img, device)
        launches = run_main_path(torch, np, img, device)
    except Exception as e:  # report the failing phase, exit nonzero
        import traceback

        traceback.print_exc()
        return fail(str(e))
    missing = [c["pair"] for c in checks
               if launches.get(tuple(getattr(torch, n) for n in c["pair"]),
                               0) == 0]
    if missing:
        return fail(f"the solve never launched K1 for {missing}")

    print(json.dumps({"kernels": [dict(
        name=f"layered_spmv[{c['pair'][0]} values, {c['pair'][1]} x]",
        route="cuda",
        source=f"{PKG}/csrc/layered_spmv.cu",
        replaces=TPU_KERNEL,
        launches=launches[tuple(getattr(torch, n) for n in c["pair"])],
        max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"])
        for c in checks]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
