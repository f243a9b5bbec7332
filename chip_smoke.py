#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and builds kernels
   K1 (the layered SpMV, csrc/layered_spmv.cu), K2 (the plane
   Gauss-Seidel sweep, csrc/plane_gs.cu), K3 (the trace's RK45,
   csrc/streamtrace.cu) and K4 (the SoA element Jacobian and residual,
   csrc/soa_element.cu) with nvcc into build/torch_kernels/, all at
   once, and prints ptxas's registers and spills;
2. assembles the lc=0.04 production channel (230,692 dofs) at the stored
   solution's state, with its multigrid hierarchy, and holds K1's
   prepared operand against its plain PyTorch version for the five
   (values, x) type pairs the solves of phases 3, 7 and 16 use, on every
   V-cycle level where they launch each, unmasked and with the BC mask
   fused in; and
   takes K1's yardsticks there: its time with L2 flushed (256 MB written
   and then 256 MB of others read between launches, outside the CUDA
   events, so L2 is cold and clean; median of 30) and back to
   back (100 launches), its bound (bytes over 3.35 TB/s), the plain
   version's time (median of 20) and one PyTorch sparse product's
   (``torch.sparse_bsr_tensor`` @ x, L2 flushed);
3. runs the main path, ``flow.channel.solve_ns_flow(10, circle, 0.5,
   lc=0.04)`` in float64 on the card, and checks that it converged, that
   it matches tests/fixtures/channel_ns_prod.npz to rel-L2 < 1e-6, that
   the solve launched K1 for each type pair and that its Stokes solve
   (``pc="mg"``, the plane-GS V-cycle) launched K2;
4. traces the card's own solution at full width,
   ``trace.pipeline.for_and_rev_streamtrace(200, ...)`` (386 forward
   seeds, a 200 x 200 reverse grid), and holds it against
   tests/fixtures/trace_prod.npz (the JAX package's CPU-f64 trace of the
   stored field): the inside/outside mask agrees on >= 99.9% of the
   seeds, the outlet-point count is within 0.2%, the kept forward
   endpoints are as many, and both directions ran K3; writes
   final_output.csv and outlet.png under build/chip_smoke/; then K3's
   row on that reverse grid (``k3_row``): K3 alone (CUDA events, median
   of 5, L2 warm) in float64 and in float32, beside its two bounds (the
   tables, seeds and outputs once over 3.35 TB/s; the longest lane's
   steps x 6 evaluations x 4 dependent loads at the L2 latency that
   ``streamtrace.chase`` measures) and the plain version's time;
5. traces the stored field itself forward, on a locator whose every
   tensor is on the card, and holds the kept endpoints to the fixture's:
   (y, z) within 1e-6, x within the event bisection's resolution (the
   trajectories amplify a 1e-9 change of the field to ~1e-4, so this is
   the phase that compares arithmetic to arithmetic);
6. runs the Reynolds-sweep warm path, ``solve_ns_flow(20, ...,
   warm=<phase 3's solution>)``, and checks that it converged without a
   coarse phase and launched K1;
7. runs the main path again with the reference's Newton KSP,
   ``solve_ns_flow(10, circle, 0.5, lc=0.04)`` with
   ``SolverConfig(ksp_type="tfqmr", pc_newton="mg_cheby")`` (the Newton
   V-cycle on f64 values; TFQMR breaks down under the bf16 one, see
   ``run_tfqmr_main_path``): checks that every Newton step ran
   TFQMR, that it converged within the Newton budget, that it matches
   channel_ns_prod.npz to rel-L2 < 1e-6 and that it launched K1 for the
   two pairs of its f64-valued V-cycles (its Stokes solve is ``pc="mg"``,
   its Newton ``mg_cheby``); prints TFQMR matvecs per Newton step and the
   wall time;
8. runs the block-CSR path at the reference's sizes, each case against
   its bar: the Ghia cavity as its CLI runs it, ``lid_driven.main(["32",
   "100"])`` (phase 18's case, held to the JAX package's results; <= 12
   Newton steps, centreline u_min in (-0.25, -0.14), corner pressure
   within 1e-12 of 0; tests/test_cavity.py); the cavity at n=24 with the
   fixture's solver settings against tests/fixtures/cavity_ns.npz; the
   duct SUPS Navier-Stokes problem of tests/parity_fixtures.py, built
   with the port's modules, against tests/fixtures/duct_ns.npz (both
   rel-L2 < 1e-6), and the same duct problem in float32, the Newton
   followed by ``refine_newton_bcsr`` (f64 residual) to 1e-8, against
   duct_ns.npz (rel-L2 < 1e-6); ``duct_stokes.solve_duct(12, 48,
   length=4)`` against
   the developed profile (rel-L2 < 0.12, transverse velocity < 5% of the
   axial maximum; tests/test_stokes_duct.py); and
   ``stokes_channel.solve_stokes_channel(circle, 0.5, lc=0.1)`` against
   tests/fixtures/stokes_channel.npz (rel-L2 < 1e-6).  Prints, for
   information, ``bcsr_matvec`` on that channel's Stokes matrix against
   a ``torch.sparse_bsr_tensor`` product of the same values (both L2
   flushed) and their byte bound;
9. DFG 2D-1 as its CLI runs it, ``apps.dfg2d.main(["0.35"])`` (phase
   18's case; 17,283 nodes, 51,849 dofs; device assembly, host SuperLU
   Newton updates) against the bars
   of tests/test_dfg.py: converged, Cd within 1% and Cl within 3% of the
   literature values, both surface-integral coefficients within 3%;
   prints nodes, Newton steps per rung, Cd, Cl and the wall split (mesh,
   Stokes LU, device assembly, scipy indexing, SuperLU);
10. the Taylor-Hood duct, ``apps.duct_stokes_th.solve_duct_th(6, 12,
   inlet="poiseuille")`` with ``method="schur"`` (fieldsplit FGMRES on
   the card) and ``method="lu"``: both within 0.06 of the developed
   profile (tests/test_taylor_hood.py), and within rel-L2 1e-6 of each
   other in velocity and in pressure on the dofs the LU does not pin as
   null pivots (there the Schur solve is undetermined); prints the outer
   FGMRES and total inner CG iterations; then, for information, the
   Schur solve at the reference's cross-section and half its length
   (12, 24, L=2);
11. DFG 3D-1Z on the layered path: K1 against its plain version on every
   V-cycle level of the pillar operator (165,600 dofs, n2d = 1,656,
   Lp = 25; the check and yardsticks of phase 2 for the three type pairs
   this solve launches), ``forms.soa.make_ugn_soa`` against the per-cell
   kernel and ``jacfwd`` on 4,096 cells of this mesh (rel 1e-10), then
   ``apps.dfg3d.solve_dfg3d_fine(0.5)`` with its defaults, uncut, against
   the bars of tests/test_dfg.py: converged, Cd within 2% of 6.18533,
   0.009401/3 < Cl < 3.5 * 0.009401, and K1 launched for each of its
   type pairs; prints each rung's Newton steps, FGMRES iterations per
   step, |F| and wall;
12. runs the route the apps take (``apps/inlet_batch.py``, ``apps/
   sweep.py``): ``solve_ns_flow(10, circle, 0.5, 0.04)`` with the default
   ``coarse_lc=0.1``, so the solve runs coarse (16,740 dofs), interpolates
   onto the fine mesh and runs the fine Newton there: converged, at least
   one fine Newton step, rel-L2 < 1e-6 against channel_ns_prod.npz;
   prints the ``interpolate``, ``fine_setup`` and ``fine_ns`` timings and
   the FGMRES counts;
13. runs the Reynolds ladder (above Re 50 the coarse Newton climbs a
   geometric Re ladder): Re=60 cold, Re=70 warm from it, Re=70 cold, all
   at lc=0.04 through the coarse-to-fine route: all converged, warm and
   cold Re=70 within rel-L2 1e-6 of each other; prints Newton steps and
   FGMRES counts per rung;
14. runs the multi-device layer on the card: a real process group of
   world size 1 (nccl, file rendezvous under build/chip_smoke/), one
   all-reduce on it; K1 against its plain version at the slab's shapes
   (the slab operand with its two zero halo planes and the halo-extended
   mask, f64 values with f64 and f32 x; and ``SlabOperand`` as a whole
   against the plain version without halo planes); then
   ``parallel.layered_shard.
   sharded_newton_layered`` on the lc=0.04 channel with ``pc="mg"``
   (slab assembly from the cell tables, K1 on the slab with its halo
   planes, the V-cycle with level 0 sharded) against
   ``solve_newton_layered`` with ``mg_cheby`` on the same problem from
   the same start (the stored solution halved, BC values re-imposed):
   both converged, rel-L2 < 1e-8 of each other, the same Newton step
   count, FGMRES counts within 1 per step, K1 launched by the sharded
   solve; and ``__graft_entry_torch__.entry()`` on the card against the
   same function on CPU tensors (rel 1e-10).  The multi-rank arithmetic
   is held on the CPU (tests/test_torch_layered_shard.py,
   tests/test_torch_sharding.py); one card proves the path runs there;
15. K2 against its plain version on every smoothed V-cycle level of the
   lc=0.04 channel (levels 0-2; the coarsest is solved densely), at the
   Stokes matrix J(0) and at the NS Jacobian of the stored solution, for
   its three type pairs (f64 values and iterate: ``pc="mg"``; bf16
   values, f32 iterate: ``mg_bf16``; f32 values and iterate: ``pc="mg"``
   in phase 16's float32 solve); its time with L2 flushed, its bound (bytes
   over 3.35 TB/s, or its FLOP where they take longer) and the plain
   version's time; per level its launch plan (the cluster size, threads,
   shared memory a block, value ring or values from memory), its stages
   and time per stage, beside the time of the same cluster running the
   stage barriers alone (the chain's floor).  No PyTorch call computes a
   plane-GS sweep, so it has no library time.  Then ``solve_linear_layered`` on that channel's
   Stokes system with ``pc="mg_cheby_bf16"``, ``"mg"`` and ``"mg_bf16"``:
   all converged, the two plane-GS solves within rel-L2 1e-6 of the
   Chebyshev one, each launching K2 for its pair; prints FGMRES counts,
   walls and launches;
16. runs the main path in float32 with refinement,
   ``solve_ns_flow(10, circle, 0.5, lc=0.04, dtype=torch.float32)`` with
   the default ``refine="auto"``: the Stokes start, the Newton and every
   FGMRES in float32, then ``refine_newton_layered`` with the residual in
   float64 on f64 geometry: checks that it refined and converged within
   ``refine_max_it`` steps, that w + w_lo matches channel_ns_prod.npz to
   rel-L2 < 1e-6, and that it launched K1 for (f32, f32) and (bf16, f32)
   and K2 for (f32, f32); prints the Stokes FGMRES count, the base
   Newton's steps, FGMRES counts and |F|, the refinement history, the
   timings beside phase 3's f64 wall, and one f64 residual and one f32
   Jacobian of that problem timed on the card (a refinement step costs
   one of each) with the f64 geometry's bytes;
17. runs the port's entry points as a user calls them, in working
   directories under build/chip_smoke/apps/: ``apps.sweep.main(["re",
   circle, "10", "20"])`` (``inlet_batch.run_trace_save`` twice at
   lc=0.04 with 200 x 200 reverse seeds: Re=10 cold through the coarse-to-
   fine route, Re=20 warm from it; each writes its XDMF pair, re-reads
   the velocity, traces it and writes the SVG figures and CSVs), then
   ``streamtrace_cli.main`` on the Re=10 checkpoint (50 x 50 seeds),
   ``ns_channel.main(["10", circle, "0.5", "0.04"])``,
   ``stokes_channel.main([circle, "0.5", "0.1"])`` and
   ``compare_images.main`` on phase 4's outlet image against itself.
   Checks: both sweep runs converged, Re=20 without a coarse phase; every
   ``.h5`` read back by ``io.xdmf.read_xdmf_function`` equals its field
   and mesh bit for bit; Re=10's velocity within rel-L2 1e-6 of
   channel_ns_prod.npz; its rev_seeds.csv within 1e-6 of trace_prod.npz's
   seeds and its final_output.csv within 0.2% of the fixture's outlet
   points; Re=20 within rel-L2 1e-6 of phase 6's; every output file
   written and every SVG well formed; streamtrace_cli's CSVs within atol
   1e-6 of a 50 x 50 trace of the in-memory Re=10 field; ns_channel
   converged; the Stokes channel converged and within rel-L2 1e-6 of
   stokes_channel.npz; compare_images' difference panel all zero; K1 and
   K2 launched; neither h5py nor matplotlib imported.  Prints, beside the
   card's name and power limit, each run's io_write_s (both files),
   io_read_s and file sizes, each CLI's wall and its split (solve, I/O,
   inlet, trace, figures, other) and the K1 and K2 launches by pair;
18. runs the last validation CLIs and the four examples as a user types
   them, each in its own directory under build/chip_smoke/cli/, and holds
   each run to the JAX package's results at the same argv
   (tests/fixtures/cli_refs.npz, by tests/torch_cli_refs.py::check_case:
   the printed lines' labels, and the figures of each case to its bar):
   ``python3 -m <pkg>.apps.dfg3d`` with no argv as a subprocess from the
   repository root (scale 1.5, the host-LU route: 7,965 velocity dofs, Cd
   and Cl relative 1e-6 of JAX's, Cd within 2% of 6.18533, exit code 0);
   ``duct_stokes.main(["12"])`` and ``duct_stokes_th.main(["6"])`` (the
   uniform inlet, Schur) in process, with no ``device=``; phases 8 and 9
   ran ``lid_driven.main(["32", "100"])`` and ``dfg2d.main(["0.35"])``
   and held them the same way; then ``PYTHONPATH=. python3
   examples/torch_<name>.py u.npy`` for poisson_1d, burgers_1d, laplace_2d
   and laplace_3d as subprocesses from the repository root, each field
   relative L2 1e-9 of JAX's.  A subprocess that exits nonzero or times
   out fails the phase.  Prints each case's wall beside the card's name
   and power limit.  These routes (block-CSR, host LU, Schur CG, CG) run
   no hand-written kernel;
19. runs the main path at bench.py's problem (circle, ratio 0.5,
   lc=0.024: 1,453,698 cells, 1,053,696 dofs) and holds it to the JAX
   package's float64 results, tests/fixtures/bench_refs.npz (written by
   tests/torch_bench_refs.py, whose rules it applies): (a) the host
   set-up (``tests/torch_bench_refs.py::port_problem``: the inlet
   profiles, the mesh, ``_setup_layered(..., mg_levels=3)``), its counts
   and checksums equal to the fixture's; (b) one NS Jacobian and one
   residual at g timed (CUDA events), K1 against its plain version
   on every V-cycle level (Lp 128, 64, 32, 16) for every pair of phase 2,
   at the NS Jacobian from g, with phase 2's yardsticks, and K2 on levels
   0-2 at J(0) for the three pairs of phase 15, with its plans (level 0:
   values from device memory in (f64, f64), 173 rows a block, two passes
   of 512 threads a stage); (c) the headline, bench.py's five ``max_it=1``
   Newton steps from g (ksp_rtol 1e-3, ``mg_cheby6_bf16``), each step's
   FGMRES its within 2 of JAX's (|F| after each step printed as a ratio
   to JAX's); (d) ``solve_ns_flow(10, circle, 0.5,
   0.024, coarse_lc=0.024)`` on the card: converged, Newton steps within 1
   of JAX's, w at 8,192 sampled dofs within rel-L2 1e-6 and the u and p
   norms within relative 1e-6 of JAX's, with its timings, K1 and K2
   launches by pair and peak memory; (e) Re=40 by the warm route from
   (d): converged, held to JAX's Re=40 as (d) is to its Re=10; (f) the
   Re=40 velocity and pressure written as XDMF by ``io/xdmf.py`` and the
   velocity re-read bit for bit, then the 200 x 200 trace of the re-read
   field twice (``trace_warm`` false, then true): outlet points within
   0.2% of JAX's f64 trace of its Re=40 field and of 21,734 (bench.py's
   round-5 record), seed_steps within 1% of JAX's f64 count (JAX's
   float32 count of the same field and round 5's 931,396, traced in
   float32 on the TPU, printed beside), and K3's row on that reverse
   grid as in phase 4; K4's row at g (``k4_row``): the Jacobian's and
   the residual's launch timed with L2 flushed (median of 10), the bound
   (``assemble/soa_element.py::bound_ms``: the buffer written once and
   the inputs read once over 3.35 TB/s, or the operations of the live
   cells over 34 TFLOP/s of f64 vector math, the larger), the plain
   twin's time (a warm call) and the largest difference to it relative to
   its largest entry, and K4's launches in the Re=10 and Re=40 solves,
   one a ``jacobian`` and a ``residual`` span of the program;
   then K4's row at the DFG 3D-1Z pillar of the benchmark (scale 0.25,
   1,492,908 tets, Lp 48, SUPS without ``transposed_stab``) at its g;
   prints every wall beside the card's name and power limit;
20. prints one JSON line of kernel results (error: the largest over the
   levels checked in phases 2, 11 and 14; times, bound and library time:
   level 0 of the channel with the mask fused, as the solve calls it, L2
   flushed; ``ms_b2b`` back to back, ``ms_unmasked`` flushed without the
   mask; ``launches``: on the pair's own path, ``path`` — phase 3 for
   the main path's three pairs, phase 7 for f64 values with f32 x,
   phase 16 ("f32") for f32 values with f32 x;
   ``launches_tfqmr``: phase 7's for every pair; ``launches_f32``:
   phase 16's; ``launches_dfg3d``:
   phase 11's solve; ``launches_sharded``: phase 14's sharded solve;
   ``launches_apps``: phase 17's entry points (K1 and K2);
   ``ms_bench``, ``bound_ms_bench``, ``plain_ms_bench``,
   ``library_ms_bench`` (K1) or ``plan_bench`` (K2): level 0 of the bench
   problem (K1 masked, K2 at J(0)), flushed; ``launches_bench``: phase
   19's Re=10 and Re=40 solves;
   ``ms_dfg3d``, ``bound_ms_dfg3d``: level 0 of the pillar operator,
   masked, flushed; ``ms_slab``, ``bound_ms_slab``: the slab operand of
   phase 14, likewise; for K2: the largest error over phase 15's levels
   and states, the times and bound at level 0 of the Stokes matrix,
   ``cluster`` and ``barrier_chain_ms`` there, the launches of phase 3
   for f64, of phase 15's ``mg_bf16`` solve for bf16 and of phase 16 for
   f32), then the final JSON status line.
   K3's entries (float64, float32): its launches in phases 4, 17 and
   19, its time, bounds and plain time on the lc=0.04 reverse grid and
   at the bench problem (``ms_bench``), ptxas's registers and spills.
   K4's entries (jacobian, residual): its launches in phase 19's
   solves, its time, bound, plain time and error at the bench problem
   and at the pillar (``ms_dfg3d``), library none (no PyTorch call
   computes the form), ptxas's registers, stack and spills.
   The block-CSR path and the host-LU path run no hand-written kernel,
   so they add no entry.

Exits nonzero, with no result, without a CUDA card or without the
repository beside it.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "stabilized_navier_stokes_flow_fenicsx_tpu_torch"
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "channel_ns_prod.npz")
TRACE_FIXTURE = os.path.join(FIXTURES, "trace_prod.npz")
BCSR_FIXTURES = tuple(os.path.join(FIXTURES, f"{name}.npz") for name in
                      ("cavity_ns", "duct_ns", "stokes_channel"))
GRAFT_ENTRY = os.path.join(ROOT, "__graft_entry_torch__.py")
CLI_REFS = os.path.join(FIXTURES, "cli_refs.npz")
CLI_RULE = os.path.join(ROOT, "tests", "torch_cli_refs.py")
CLI_ROOT = os.path.join(ROOT, "build", "chip_smoke", "cli")
DFG3D_CD = 6.18533         # the literature drag of 3D-1Z (tests/test_dfg.py)
RE, RATIO, LC = 10.0, 0.5, 0.04
RE_WARM = 20.0
NUM_SEEDS = 200            # reverse grid per side (InletBatchScript.py:41)
TPU_KERNEL = ("stabilized_navier_stokes_flow_fenicsx_tpu/assemble/"
              "pallas_spmv.py:107")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published memory rate
FLUSH_BYTES = 256 * 2 ** 20  # written between flushed launches (> 50 MB L2)
# (values dtype, x dtype, rel-L2 tolerance of kernel vs plain, the path
# whose launches the kernels line reports: "main" = phase 3, "tfqmr" =
# phase 7, "f32" = phase 16): f64 differs only in summation order; with
# bf16 values the plain version rounds each product to bf16, the kernel
# takes it in the x dtype; f64 values with f32 x (phase 7's mg_cheby
# smoother) and f32 values with f32 x (phase 16's operator and Stokes
# V-cycle) sum in f32
PAIRS = (("float64", "float64", 1e-12, "main"),
         ("bfloat16", "float32", 5e-3, "main"),
         ("bfloat16", "float64", 5e-3, "main"),
         ("float64", "float32", 1e-5, "tfqmr"),
         ("float32", "float32", 1e-5, "f32"))
# K2, the plane-GS sweep: (values dtype, iterate dtype, rel-L2 tolerance
# of kernel vs plain, the path whose launches the kernels line reports:
# "main" = phase 3, whose Stokes solve runs pc="mg"; "mg_bf16" = phase
# 15's Stokes solve with that PC; "f32" = phase 16, whose f32 Stokes solve
# runs pc="mg").  Both sides read the same values and inverses and compute
# in the iterate's type; they differ in the summation order of the 2D
# products only, which the sweep carries from plane to plane (hence
# 1e-10, not K1's 1e-12, in f64)
K2_PAIRS = (("float64", "float64", 1e-10, "main"),
            ("bfloat16", "float32", 1e-4, "mg_bf16"),
            ("float32", "float32", 1e-4, "f32"))
K2_REPLACES = ("stabilized_navier_stokes_flow_fenicsx_tpu/solve/"
               "precond.py:251")


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


class L2Flush:
    """Leaves L2 cold and clean: writes ``FLUSH_BYTES`` (> the 50 MB L2),
    then reads as many others, so that the written lines are back in
    memory before the timed call and their write-back is not timed."""

    def __init__(self, torch, device):
        self.write = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)
        self.read = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32,
                               device=device)

    def __call__(self):
        self.write.fill_(1)
        self.read.sum()


def time_flushed_ms(fn, flush, n: int = 30) -> float:
    """Median milliseconds of one call of ``fn`` with L2 cold: before each
    timed call ``flush()`` runs on the card (outside the events), which
    also keeps the card busy while the host enqueues the call."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_b2b_ms(fn, n: int = 100) -> float:
    """Milliseconds per call over n calls back to back (one pair of CUDA
    events; L2 stays warm, and a call whose host work outlasts its device
    work is timed by the host)."""
    import torch

    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def solve_levels(n_lv: int) -> dict:
    """The V-cycle levels each (values, x) pair runs on in the solves:
    f64 values with f64 x are the outer operator (level 0) and, in phase
    7's f64-valued V-cycle, the residuals of every level but the coarsest
    (solved densely); x in f32 are the smoothers and spectral estimates
    on every level, with bf16 values (mg_cheby_bf16: the Stokes solve and
    phase 3's Newton) or f64 ones (mg_cheby: phase 7's Newton); bf16
    values with f64 x are the bf16 V-cycle's residuals; f32 values with
    f32 x are phase 16's outer operator (level 0) and the residuals of its
    f32 plane-GS Stokes V-cycle (every level but the coarsest)."""
    return {("float64", "float64"): range(n_lv - 1),
            ("bfloat16", "float32"): range(n_lv),
            ("bfloat16", "float64"): range(n_lv - 1),
            ("float64", "float32"): range(n_lv),
            ("float32", "float32"): range(n_lv - 1)}


def k1_bytes(op, vdtype, xdtype, masked: bool) -> int:
    """Bytes one K1 call must move: the 48 * E * Lp real values (not the
    layout's padding), x read once, the mask read once when fused, y
    written once, and the pair tables (cols, row_ptr)."""
    import torch

    E, Lp, n2d = op.values.shape[3], op.n_planes, op.n2d
    vsize = torch.tensor([], dtype=vdtype).element_size()
    asize = torch.tensor([], dtype=xdtype).element_size()
    ndofs = Lp * n2d * 4
    return (48 * E * Lp * vsize + (3 if masked else 2) * ndofs * asize
            + 8 * E + 8 * (n2d + 1))


def k1_bound(op, vdtype, xdtype, masked: bool):
    """(bound_ms, bound_by): the larger of the bytes over the H100's
    3.35 TB/s and the 2 * 48 * E * Lp FLOP over its peak for x's type
    outside the tensor cores (67 TFLOP/s f32, 34 TFLOP/s f64; NVIDIA's
    H100 SXM data sheet)."""
    import torch

    t_bytes = k1_bytes(op, vdtype, xdtype, masked) / HBM_BYTES_PER_S * 1e3
    flops = 2 * 48 * op.values.shape[3] * op.n_planes
    peak = 34e12 if xdtype == torch.float64 else 67e12
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(torch, op, vdtype, x, masked: bool):
    """One PyTorch call computing K1's product, as yardstick: the level's
    matrix built once as a 4x4 ``torch.sparse_bsr_tensor`` (with the BC
    projection m A m + (I - m) when masked), ``A @ x``; in the values
    dtype if torch's CUDA sparse product takes it, else float32, else as
    CSR.  Returns (fn, label).  The port never calls it."""
    V, n2d, Lp = op.values, op.n2d, op.n_planes
    E, N, dev = V.shape[3], op.n2d * op.n_planes, V.device
    d = torch.arange(3, device=dev)[:, None, None]
    e = torch.arange(E, device=dev)[None, :, None]
    lv = torch.arange(Lp, device=dev)[None, None, :]
    lc = lv + d - 1
    valid = ((lc >= 0) & (lc < Lp)).expand(3, E, Lp)
    R = (lv * n2d + op.row_ids[e]).expand(3, E, Lp)[valid]
    C = (lc * n2d + op.cols[e]).expand(3, E, Lp)[valid]
    blocks = V.permute(2, 3, 4, 0, 1)[valid]               # (nb, 4, 4)
    if masked:
        m = op.mask.to(V.dtype).reshape(-1, 4)
        blocks = blocks * m[R][:, :, None] * m[C][:, None, :]
        diag = R == C
        blocks[diag] += torch.diag_embed(1.0 - m[R[diag]])
    order = torch.argsort(R * N + C)
    R, C, blocks = R[order], C[order], blocks[order]
    crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(R, minlength=N), 0)
    dtypes = [vdtype] + ([torch.float32] if vdtype != torch.float64 else [])
    errors = []
    for layout in ("bsr", "csr"):
        for dt in dtypes:
            try:
                A = torch.sparse_bsr_tensor(crow, C, blocks.to(dt),
                                            size=(4 * N, 4 * N))
                if layout == "csr":
                    A = A.to_sparse_csr()
                xc = x.to(dt)[:, None]
                fn = functools.partial(torch.matmul, A, xc)
                y = fn()
                torch.cuda.synchronize()
                if y.shape != (4 * N, 1):
                    raise RuntimeError(f"shape {tuple(y.shape)}")
                return fn, f"{layout} {str(dt).removeprefix('torch.')}"
            except (RuntimeError, NotImplementedError, TypeError) as err:
                errors.append(f"{layout} {dt}: {str(err).splitlines()[0]}")
    raise RuntimeError(f"no PyTorch sparse product ran: {errors}")


def k1_levels(torch, np, img, device):
    """The lc=0.04 channel's V-cycle levels (solve/mg.py::LevelOperator,
    f64 canonical values) at the stored solution's state, on the card:
    the operands the solve hands K1."""
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
    return levels


def check_levels(torch, np, levels, pairs, device, on_levels=None):
    """K1 vs its plain version on every V-cycle level in ``levels`` where
    the solve launches each type pair of ``pairs`` (``on_levels``: the
    levels by pair; those of ``solve_levels`` when None), unmasked and
    with the BC mask fused in; and its yardsticks there: the time with L2
    flushed and back to back, the bound, and a library call's time."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)

    flush = L2Flush(torch, device)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal(op.mask.numel()),
                          device=device) for op in levels]
    if on_levels is None:
        on_levels = solve_levels(len(levels))
    results = []
    for vname, xname, tol, path in pairs:
        vdt, xdt = getattr(torch, vname), getattr(torch, xname)
        errs, row = [], {}
        for k in on_levels[(vname, xname)]:
            op = levels[k]
            xt = xs[k].to(xdt)
            for masked in (False, True):
                K = layered_spmv.LayeredOperand(
                    op.values, op.cols, op.row_ptr, op.n2d,
                    mask=op.mask if masked else None, dtype=vdt)
                y_k = K(xt)
                torch.cuda.synchronize()
                y_p = layered_spmv.layered_matvec_plain(K, xt)
                torch.cuda.synchronize()
                diff = (y_k.double() - y_p.double())
                max_abs = float(diff.abs().max())
                rel = float(torch.linalg.vector_norm(diff)
                            / torch.linalg.vector_norm(y_p.double()))
                tag = "masked" if masked else "unmasked"
                if not torch.isfinite(y_k).all() or rel > tol:
                    raise RuntimeError(
                        f"K1 ({vname} values, {xname} x, {tag}) disagrees "
                        f"with its plain version on level {k}: rel-L2 "
                        f"{rel:.3e} > {tol:g}")
                errs.append(max_abs)
                ms = time_flushed_ms(lambda: K(xt), flush)
                b2b = time_b2b_ms(lambda: K(xt))
                plain_ms = time_ms(
                    lambda: layered_spmv.layered_matvec_plain(K, xt))
                bound, bound_by = k1_bound(op, vdt, xdt, masked)
                lib_fn, lib_name = library_call(torch, op, vdt, xt, masked)
                lib_ms = time_flushed_ms(lib_fn, flush)
                lib_b2b = time_b2b_ms(lib_fn)
                del lib_fn
                print(f"K1 ({vname} values, {xname} x) level {k} {tag}: "
                      f"rel-L2 {rel:.3e} (tol {tol:g}), max abs err "
                      f"{max_abs:.3e}; L2-flushed {ms:.4f} ms, back to back "
                      f"{b2b:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
                      f"{bound / ms:.1%} of it flushed), plain "
                      f"{plain_ms:.4f} ms, library ({lib_name}) flushed "
                      f"{lib_ms:.4f} ms, back to back {lib_b2b:.4f} ms",
                      flush=True)
                if k == 0:
                    row[tag] = dict(ms=ms, ms_b2b=b2b, plain_ms=plain_ms,
                                    bound_ms=bound, bound_by=bound_by,
                                    library_ms=lib_ms, library=lib_name)
        # the JSON line's times: level 0 with the mask fused, as the solve
        # calls it; the unmasked flushed time beside it
        results.append(dict(pair=(vname, xname), path=path,
                            max_abs_err=max(errs),
                            ms_unmasked=row["unmasked"]["ms"],
                            **row["masked"]))
    del flush
    return results


def run_main_path(torch, np, img, device):
    """Phase 3: the lc=0.04 continuation solve on the card."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import plane_gs
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        solve_ns_flow)

    layered_spmv.reset_launches()
    plane_gs.reset_launches()
    t0 = time.perf_counter()
    sol = solve_ns_flow(RE, img, RATIO, channel_mesh_size=LC, coarse_lc=LC,
                        device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(layered_spmv.LAUNCHES_BY_DTYPES)
    total = layered_spmv.LAUNCHES
    k2_launches = dict(plane_gs.LAUNCHES_BY_DTYPES)

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
    print(f"K1 launches in the solve: {total} {_by_pair(launches)}",
          flush=True)
    print(f"K2 launches in the solve (its Stokes V-cycle, pc="
          f"{DEFAULT.solver.pc!r}): {plane_gs.LAUNCHES} "
          f"{_by_pair(k2_launches)}", flush=True)

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
    if plane_gs.LAUNCHES <= 0:
        raise RuntimeError("the solve never launched K2")
    return launches, k2_launches, sol, wall


def _on_card(*tensors) -> bool:
    return all(t.is_cuda for t in tensors)


def run_trace(torch, np, img, sol, device):
    """Phase 4: the full-width trace of the card's own solution."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.tri2d import (
        points_in_polygon)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.postprocess.outlet_image import (
        outlet_image_from_trace)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace.pipeline import (
        for_and_rev_streamtrace)

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (
        streamtrace)

    fx = np.load(TRACE_FIXTURE)
    inlet1, _ = solve_inlet_profiles(img, RATIO, DEFAULT)
    streamtrace.reset_launches()
    t0 = time.perf_counter()
    res = for_and_rev_streamtrace(NUM_SEEDS, img, sol.mesh, sol.u,
                                  inlet1.mesh.points, DEFAULT, device=device)
    wall = time.perf_counter() - t0
    k3_launches = streamtrace.LAUNCHES
    st = res.stats
    inside = points_in_polygon(res.reverse_endpoints[:, 1:3],
                               res.inner_contour)
    flips = int((inside != fx["inside"]).sum()) \
        if inside.shape == fx["inside"].shape else len(inside)
    n_out, n_out_ref = len(res.outlet_points), len(fx["outlet_points"])
    fe, fe_ref = res.forward_endpoints, fx["forward_endpoints"]
    print(f"trace: {wall:.3f} s wall; locator_build_s "
          f"{st['locator_build_s']:.4f}, fwd_s {st['fwd_s']:.4f}, rev_s "
          f"{st['rev_s']:.4f}; seeds {st['seeds']}, seed_steps "
          f"{st['seed_steps']} (fixture {int(fx['seed_steps'])}), "
          f"lane_steps {st['lane_steps']}, dispatches {st['dispatches']}, "
          f"K3 launches {k3_launches}", flush=True)
    print(f"trace vs trace_prod.npz: kept forward {len(fe)} (fixture "
          f"{len(fe_ref)}), outlet points {n_out} (fixture {n_out_ref}), "
          f"mask flips {flips} of {len(inside)}", flush=True)
    if len(fe) == len(fe_ref):
        d = np.abs(fe - fe_ref)
        print(f"kept forward endpoints vs fixture (own solution): max abs "
              f"x {d[:, 0].max():.3e}, y {d[:, 1].max():.3e}, z "
              f"{d[:, 2].max():.3e}; (y, z) within 1e-6 for "
              f"{(d[:, 1:].max(axis=1) <= 1e-6).mean():.4f} of them",
              flush=True)
    work = os.path.join(ROOT, "build", "chip_smoke")
    np.savetxt(os.path.join(work, "final_output.csv"), res.outlet_points,
               delimiter=",")
    outlet_image_from_trace(res.seeds, res.reverse_endpoints,
                            res.inner_contour,
                            path=os.path.join(work, "outlet.png"))
    if not np.isfinite(res.forward_endpoints).all() \
            or not np.isfinite(res.reverse_endpoints).all():
        raise RuntimeError("non-finite trace endpoints")
    if res.seeds.shape != fx["seeds"].shape:
        raise RuntimeError(f"reverse grid {res.seeds.shape} != fixture "
                           f"{fx['seeds'].shape}")
    if flips > 1e-3 * len(inside):
        raise RuntimeError(f"{flips} of {len(inside)} seeds flipped "
                           f"inside/outside (bar 0.1%)")
    if abs(n_out - n_out_ref) > 2e-3 * n_out_ref:
        raise RuntimeError(f"outlet points {n_out} vs fixture {n_out_ref} "
                           f"(bar 0.2%)")
    if len(fe) != len(fe_ref):
        raise RuntimeError(f"kept forward endpoints {len(fe)} vs fixture "
                           f"{len(fe_ref)}")
    if k3_launches != 2:
        raise RuntimeError(f"the trace launched K3 {k3_launches} times, "
                           f"not once per direction")
    row = k3_row(torch, np, sol.mesh, sol.u, res.seeds, device,
                 "lc=0.04 reverse grid")
    row["launches"] = k3_launches
    return inlet1, row


def check_trace_arithmetic(torch, np, sol, inlet1, device):
    """Phase 5: the stored field traced forward on the card against the
    fixture's kept forward endpoints."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.interpolate import (
        LayeredDeviceLocator, build_trace_locator)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace.pipeline import (
        SEED_CHUNK, trace_config)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace.streamtrace import (
        trace_particles)

    tc = DEFAULT.trace
    u_ref, _ = sol.space.split(np.load(FIXTURE)["w"])
    dloc = build_trace_locator(sol.mesh, device=device)
    if not isinstance(dloc, LayeredDeviceLocator) or not _on_card(
            *(v for v in vars(dloc).values() if isinstance(v, torch.Tensor))):
        raise RuntimeError("the trace locator is not a layered locator on "
                           "the card")
    seeds = np.hstack([np.zeros((len(inlet1.mesh.points), 1)),
                       inlet1.mesh.points])
    ends = trace_particles(trace_config(tc), dloc,
                           torch.as_tensor(u_ref, device=device), seeds,
                           chunk=SEED_CHUNK)
    if not _on_card(ends):
        raise RuntimeError("the trace endpoints are not on the card")
    ends = ends.cpu().numpy()
    kept = ends[ends[:, 0] > tc.x_forward_keep]
    fe_ref = np.load(TRACE_FIXTURE)["forward_endpoints"]
    if kept.shape != fe_ref.shape:
        raise RuntimeError(f"stored field: kept forward endpoints "
                           f"{len(kept)} vs fixture {len(fe_ref)}")
    d = np.abs(kept - fe_ref)
    x_res = 2.0 ** -16 * tc.max_step * np.abs(u_ref[:, 0]).max()
    print(f"stored field traced on the card: kept forward {len(kept)}; max "
          f"abs vs fixture x {d[:, 0].max():.3e} (bar {x_res:.3e}, the "
          f"bisection's resolution), y {d[:, 1].max():.3e}, z "
          f"{d[:, 2].max():.3e} (bar 1e-6)", flush=True)
    if d[:, 1:].max() > 1e-6 or d[:, 0].max() > x_res:
        raise RuntimeError("stored field: kept forward endpoints disagree "
                           "with the fixture")


K3_REPLACES = ("none: the JAX package traces with jnp code "
               "(stabilized_navier_stokes_flow_fenicsx_tpu/trace/"
               "streamtrace.py::trace_segment under vmap), no Pallas kernel")
CHASE_LOADS = 100_000       # dependent loads a latency reading follows


def ptxas_lines(np) -> dict:
    """K3's registers and spill bytes by instantiation, from this
    process's nvcc log (utils/nvcc.py::LOGS)."""
    import re

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import nvcc

    out, fn = {}, None
    for line in nvcc.LOGS.get("streamtrace", "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = ("float64" if "IdE" in m.group(1) else "float32"
                  if "IfE" in m.group(1) else "chase")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out.setdefault(fn, {}).update(spill_stores=int(m.group(1)),
                                          spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def load_latency_ns(torch, device, nbytes: int) -> float:
    """ns per load of one thread chasing a random cycle through an int64
    table of ``nbytes`` (K3's yardstick: L2 for a table L2 holds)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (
        streamtrace)

    m = nbytes // 8
    perm = torch.randperm(m, device=device)
    nxt = torch.empty(m, dtype=torch.int64, device=device)
    nxt[perm] = torch.roll(perm, -1)
    streamtrace.chase(nxt, CHASE_LOADS)          # warm: the cycle cached
    ms = time_ms(lambda: streamtrace.chase(nxt, CHASE_LOADS), n=3)
    return ms * 1e6 / CHASE_LOADS


K4_REPLACES = ("none: the JAX package evaluates the SoA element forms with "
               "jnp code (stabilized_navier_stokes_flow_fenicsx_tpu/forms/"
               "soa.py::make_sups_soa, make_ugn_soa), no Pallas kernel")
K4_ENTRIES = ("jacobian", "residual")
K4_PILLAR_SCALE = 0.25     # the benchmark's dfg3d-1z (near_growth 0.15)


def k4_ptxas() -> dict:
    """K4's registers, stack frame and spill bytes by instantiation
    (entry, flux code, dtype), from this process's nvcc log."""
    import re

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import nvcc

    out, fn = {}, None
    for line in nvcc.LOGS.get("soa_element", "").splitlines():
        m = re.search(r"soa_(jacobian|residual)_kernelILi(\d)E([df])E", line)
        if m and "Compiling entry function" in line:
            fn = (f"{m.group(1)}[{m.group(2)}, "
                  f"{'float64' if m.group(3) == 'd' else 'float32'}]")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out.setdefault(fn, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def k4_row(torch, np, kern, sasm, Lp: int, w, label: str) -> dict:
    """K4's Jacobian and residual launches on the plan ``sasm`` at the
    state w: each timed with L2 flushed, its bound, the plain twin's
    time (its second call, host clock around a synchronise), the largest
    difference to the twin relative to the twin's largest entry, and
    ptxas's lines when this process built the library."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        soa_element, structured)

    flush = L2Flush(torch, w.device)
    live = int(sasm.alive.sum())
    flux = soa_element.kernel_args(kern)[0]
    row = {"label": label, "cells": int(sasm.alive.numel()),
           "live_cells": live, "ptxas": k4_ptxas()}
    plain = {"jacobian": structured._jac_buffer_plain,
             "residual": structured._res_buffer_plain}
    for entry in K4_ENTRIES:
        fn = getattr(soa_element, entry)
        ms = time_flushed_ms(lambda: fn(kern, sasm, Lp, w), flush, n=10)
        out = fn(kern, sasm, Lp, w)
        plain[entry](kern, Lp, sasm, w)         # warm, as in a solve
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twin = plain[entry](kern, Lp, sasm, w)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        scale = float(twin.abs().max())
        rel = float((out - twin).abs().max()) / scale
        del out, twin
        b = soa_element.bound_ms(entry, flux, sasm, Lp, w, live)
        row[entry] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["ms"],
                          bound_by=b["bound_by"], bytes=b["bytes"],
                          flops=b["flops"], rel_err=rel)
        print(f"K4 {label} {entry}: {ms:.3f} ms flushed ({live} live of "
              f"{row['cells']} cells, {str(w.dtype)[6:]}); bound "
              f"{b['ms']:.3f} ms ({b['bound_by']}: {b['bytes'] / 1e9:.3f} "
              f"GB at 3.35 TB/s {b['bytes_ms']:.3f} ms, "
              f"{b['flops'] / 1e9:.2f} GFLOP {b['flops_ms']:.3f} ms; "
              f"{b['ms'] / ms:.1%} of it); plain twin {plain_ms:.1f} ms; "
              f"max |K4 - twin| / max |twin| {rel:.2e}", flush=True)
        _bar(rel <= 1e-12, f"K4 {label} {entry} within 1e-12 of its twin")
    del flush
    print(f"K4 ptxas: {json.dumps(row['ptxas'])}", flush=True)
    if row["ptxas"]:          # this process built the library
        _bar(all(v.get("spill_stores", 1) == 0
                 and v.get("spill_loads", 1) == 0
                 for v in row["ptxas"].values())
             and len(row["ptxas"]) == 12,
             "K4: 12 instantiations, 0 spill bytes")
    return row


def k3_row(torch, np, mesh, u, seeds, device, label: str) -> dict:
    """K3 alone on ``seeds`` (a reverse grid) of the field ``u`` on
    ``mesh``, float64 and float32, with its bounds and the plain
    version's time."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.interpolate import (
        build_trace_locator)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (
        streamtrace)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace.pipeline import (
        SEED_CHUNK, trace_config)

    cfg = trace_config(DEFAULT.trace, reverse=True)
    cfg_k3 = dataclasses.replace(cfg, sign=-1.0)
    l2_ns = load_latency_ns(torch, device, 8 * 2 ** 20)
    row = {"label": label, "lanes": len(seeds), "l2_latency_ns": l2_ns}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        dloc = build_trace_locator(mesh, dtype, device)
        u_cell = streamtrace.pack_u_cells(
            dloc, torch.as_tensor(u, dtype=dtype, device=device))
        x0 = torch.as_tensor(seeds, dtype=dtype, device=device)
        ms = time_ms(lambda: streamtrace.trace_k3(cfg_k3, dloc, u_cell, x0),
                     n=5)
        _, steps, done = streamtrace.trace_k3(cfg_k3, dloc, u_cell, x0)
        longest = int(steps.max())
        tables = (dloc.x_planes, dloc.tab2, dloc.prism_base,
                  dloc.prism_geom, u_cell)
        nbytes = (sum(t.numel() * t.element_size() for t in tables)
                  + 2 * x0.numel() * x0.element_size() + 9 * len(seeds))
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_chain = longest * 6 * 4 * l2_ns * 1e-6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streamtrace.trace_particles_plain(cfg, dloc, u_cell.new_tensor(u),
                                          seeds, reverse=True,
                                          chunk=SEED_CHUNK)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        row[name] = dict(ms=ms, bound_bytes_ms=bound_bytes,
                         bound_chain_ms=bound_chain, table_bytes=nbytes,
                         longest_lane_steps=longest,
                         seed_steps=int(steps.sum()), done=int(done.sum()),
                         plain_ms=plain_ms)
        print(f"K3 {label} {name}: {ms:.3f} ms for {len(seeds)} lanes "
              f"(longest {longest} steps, seed_steps {int(steps.sum())}, "
              f"done {int(done.sum())}); bounds: bytes {bound_bytes:.4f} ms "
              f"({nbytes / 2 ** 20:.1f} MiB), chain {bound_chain:.3f} ms "
              f"({longest} x 6 x 4 loads at {l2_ns:.1f} ns, the L2 "
              f"latency); plain version {plain_ms:.1f} ms", flush=True)
    row["ptxas"] = ptxas_lines(np)
    print(f"K3 ptxas: {json.dumps(row['ptxas'])}", flush=True)
    return row


def run_warm_sweep(torch, np, img, sol, device):
    """Phase 6: the Reynolds-sweep warm path from phase 3's solution.
    Returns the Re=20 solution."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        solve_ns_flow)

    layered_spmv.reset_launches()
    t0 = time.perf_counter()
    sol20 = solve_ns_flow(RE_WARM, img, RATIO, channel_mesh_size=LC,
                          warm=sol, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = layered_spmv.LAUNCHES
    h = sol20.newton_history.get("fine_ns", np.zeros((0, 4)))
    print(f"warm Re={RE_WARM:g} solve: {wall:.2f} s wall, timings "
          f"{json.dumps({k: round(v, 4) for k, v in sol20.timings.items()})}",
          flush=True)
    print(f"warm Re={RE_WARM:g}: Newton its {sol20.newton_iters}, FGMRES its "
          f"{[int(r[2]) for r in h]}, |F| {sol20.newton_resnorm:.3e}, "
          f"converged {sol20.converged}, K1 launches {launches}", flush=True)
    if not sol20.converged or not np.isfinite(sol20.w).all():
        raise RuntimeError("the warm solve did not converge")
    coarse = [k for k in sol20.timings
              if k.startswith("coarse") or k in ("stokes", "interpolate")]
    if coarse:
        raise RuntimeError(f"the warm solve ran coarse phases {coarse}")
    if launches <= 0:
        raise RuntimeError("the warm solve never launched K1")
    return sol20


def run_tfqmr_main_path(torch, np, img, device):
    """Phase 7: the lc=0.04 solve with TFQMR as the Newton KSP."""
    import dataclasses

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (
        DEFAULT, SolverConfig)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        solve_ns_flow)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import newton

    # TFQMR needs a fixed linear preconditioner: under the bf16 V-cycle
    # (f32 iterate over bf16 values) its quasi-residual stalled at the
    # 2,000-matvec budget on Newton steps 2 and 3 and broke down to NaN on
    # step 4 at this size on the H100 (PERF.md), so its Newton runs
    # the V-cycle on f64 values (mg_cheby); the Stokes solve keeps the
    # default pc="mg" (plane GS on f64 values) with FGMRES
    scfg = SolverConfig(ksp_type="tfqmr", pc_newton="mg_cheby")
    cfg = dataclasses.replace(DEFAULT, solver=scfg)
    tfqmr, runs = newton.tfqmr, []

    def counted_tfqmr(*args, **kwargs):
        out = tfqmr(*args, **kwargs)
        runs.append(out.iters)
        return out

    newton.tfqmr = counted_tfqmr
    try:
        layered_spmv.reset_launches()
        t0 = time.perf_counter()
        sol = solve_ns_flow(RE, img, RATIO, channel_mesh_size=LC,
                            coarse_lc=LC, cfg=cfg, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        newton.tfqmr = tfqmr
    launches = dict(layered_spmv.LAUNCHES_BY_DTYPES)
    total = layered_spmv.LAUNCHES
    steps = [row for h in sol.newton_history.values() for row in h]
    budget = scfg.ksp_restart * 40
    print(f"TFQMR solve_ns_flow: {wall:.2f} s wall, timings "
          f"{json.dumps({k: round(v, 4) for k, v in sol.timings.items()})}",
          flush=True)
    for name, h in sol.newton_history.items():
        print(f"{name} (TFQMR): matvecs per Newton step "
              f"{[int(r[2]) for r in h]}, lambda {[float(r[1]) for r in h]}, "
              f"|F| {[float('%.3e' % r[0]) for r in h]}", flush=True)
    by_pair = _by_pair(launches)
    print(f"TFQMR: {len(steps)} Newton steps, {len(runs)} TFQMR runs, "
          f"{sum(runs)} matvecs ({sum(r >= budget for r in runs)} at the "
          f"{budget}-matvec budget); K1 launches {total} {by_pair}",
          flush=True)
    if not sol.converged or not np.isfinite(sol.w).all():
        raise RuntimeError("the TFQMR solve did not converge")
    if not 0 < len(steps) <= scfg.newton_max_it:
        raise RuntimeError(f"the TFQMR solve took {len(steps)} Newton steps")
    if runs != [int(r[2]) for r in steps]:
        raise RuntimeError(f"Newton steps {len(steps)} did not all run "
                           f"TFQMR (runs {runs})")
    rel = float(np.linalg.norm(sol.w - np.load(FIXTURE)["w"])
                / np.linalg.norm(np.load(FIXTURE)["w"]))
    print(f"TFQMR rel-L2 vs channel_ns_prod.npz: {rel:.3e} (bar 1e-6)",
          flush=True)
    if rel >= 1e-6:
        raise RuntimeError(f"TFQMR solution rel-L2 {rel:.3e} >= 1e-6")
    return launches


def _rel(np, a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bar(ok: bool, what: str) -> None:
    print(f"  {what}: {'ok' if ok else 'MISSED'}", flush=True)
    if not ok:
        raise RuntimeError(f"bar missed: {what}")


class CliRuns:
    """Phase 18's cases: a CLI or example run as a user runs it, in its own
    working directory under build/chip_smoke/cli/, and held by
    tests/torch_cli_refs.py::check_case to the JAX package's results at
    the same argv (tests/fixtures/cli_refs.npz).  ``walls`` keeps each
    case's wall."""

    def __init__(self):
        tests = os.path.dirname(CLI_RULE)
        if tests not in sys.path:
            sys.path.append(tests)
        import torch_cli_refs

        self.rule = torch_cli_refs
        self.refs = torch_cli_refs.load(CLI_REFS)
        self.walls = {}

    def _workdir(self, name: str) -> str:
        d = os.path.join(CLI_ROOT, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        return d

    def in_process(self, name: str):
        """``apps/<name>.py``'s ``main(argv)`` at the fixture's argv with no
        ``device=`` (so on the card, through ``config.default_device``),
        as the CLI's ``__main__`` calls it; held to JAX's.  Returns what
        ``main`` returned."""
        argv = self.refs[name]["argv"]
        cwd = os.getcwd()
        os.chdir(self._workdir(name))
        try:
            result, lines, wall = self.rule.run_case(PKG, name, argv)
        finally:
            os.chdir(cwd)
        self._hold(name, f"{name}.main({argv})", lines, result, wall)
        return result

    def command(self, name: str, cmd, shown: str, timeout: float,
                env=None, field=None):
        """``cmd`` as a subprocess from the repository root, its output
        kept in the case's directory; fails unless it exits 0 within
        ``timeout`` s.  ``field``: the .npy it writes, an example's result.
        Returns its printed lines."""
        import numpy as np

        d = self._workdir(name)
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=timeout)
        wall = time.perf_counter() - t0
        for stream, text in (("stdout", p.stdout), ("stderr", p.stderr)):
            with open(os.path.join(d, f"{stream}.txt"), "w") as f:
                f.write(text)
        if p.returncode != 0:
            raise RuntimeError(f"{shown} exited {p.returncode}: "
                               f"{p.stderr[-3000:]}")
        lines = p.stdout.splitlines()
        self._hold(name, f"{shown} (exit 0)", lines,
                   None if field is None else np.load(field), wall)
        return lines

    def _hold(self, name, shown, lines, result, wall) -> None:
        self.walls[name] = wall
        print(f"{shown}: {wall:.2f} s wall", flush=True)
        for line in lines:
            print(f"  | {line}", flush=True)
        for what, ok, detail in self.rule.check_case(name, lines, result,
                                                     self.refs):
            print(f"  {name}: {detail}", flush=True)
            _bar(ok, f"{name}: {what}")


def run_bcsr_cases(torch, np, img, device, cli):
    """Phase 8: the block-CSR path at the reference's sizes, the Ghia
    cavity through ``lid_driven.main``."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (
        duct_stokes, lid_driven, stokes_channel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (
        asm_arrays_in, assembler_for_mixed)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (
        SolverConfig)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (
        bc_mask, bc_vector)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (
        duct_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (
        refine_newton_bcsr, solve_newton_bcsr)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.exact import (
        square_duct_mean, square_duct_profile)

    cavity_fx, duct_fx, channel_fx = (np.load(f) for f in BCSR_FIXTURES)

    r = cli.in_process("lid_driven")      # lid_driven.main(["32", "100"])
    pts = r.mesh.points
    umin = float(r.u[np.abs(pts[:, 0] - 0.5) < 1e-9, 0].min())
    corner = int(np.argmin(pts[:, 0] ** 2 + pts[:, 1] ** 2))
    print(f"Ghia cavity n=32 Re=100: {cli.walls['lid_driven']:.2f} s, "
          f"{len(r.w)} dofs, Newton its {r.newton_iters}, |F| "
          f"{r.newton_resnorm:.3e}, centreline u_min {umin:.4f} (Ghia "
          f"-0.2109), corner p {r.p[corner]:.1e}", flush=True)
    _bar(r.converged and r.newton_iters <= 12,
         "cavity converged in <= 12 Newton steps")
    _bar(-0.25 < umin < -0.14, "centreline u_min in (-0.25, -0.14)")
    _bar(abs(r.p[corner]) < 1e-12, "corner pressure within 1e-12 of 0")

    t0 = time.perf_counter()
    cfg = SolverConfig(newton_rtol=1e-11, newton_atol=0.0, ksp_rtol=1e-10)
    r = lid_driven.solve_lid_driven(int(cavity_fx["n"]),
                                    float(cavity_fx["Re"]), solver=cfg,
                                    device=device)
    rel = _rel(np, r.w, cavity_fx["w"])
    print(f"cavity n=24 (fixture settings): {time.perf_counter() - t0:.2f} "
          f"s, Newton its {r.newton_iters}, |F| {r.newton_resnorm:.3e}, "
          f"rel-L2 vs cavity_ns.npz {rel:.3e}", flush=True)
    _bar(r.converged and rel < 1e-6, "cavity_ns.npz rel-L2 < 1e-6")

    t0 = time.perf_counter()
    mesh = duct_mesh(int(duct_fx["n_cross"]), int(duct_fx["n_axial"]),
                     float(duct_fx["length"]))
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, device=device)
    bc = duct_stokes.duct_bcs(mesh, W)
    pat = asm.pattern
    out = solve_newton_bcsr(
        make_ns_sups_kernel("tetrahedron", 1.0 / float(duct_fx["Re"])),
        asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays,
        asm.vector(bc_mask(W.ndofs, bc)), asm.vector(bc_vector(W.ndofs, bc)),
        asm.vector(np.zeros(W.ndofs)), rtol=1e-10, atol=1e-10, max_it=30,
        ksp_rtol=1e-10)
    rel = _rel(np, out.x.cpu().numpy(), duct_fx["w"])
    print(f"duct SUPS NS Re=20: {time.perf_counter() - t0:.2f} s, Newton "
          f"its {out.iters}, FGMRES its "
          f"{[int(h[2]) for h in out.history]}, rel-L2 vs duct_ns.npz "
          f"{rel:.3e}", flush=True)
    _bar(out.converged and rel < 1e-6, "duct_ns.npz rel-L2 < 1e-6")

    # the same problem in float32: the Newton to its floor (FGMRES at
    # 1e-6), then refinement with the f64 residual to 1e-8, as
    # tests/parity_fixtures.py::solve_duct_ns runs it
    t0 = time.perf_counter()
    asm32 = assembler_for_mixed(W, dtype=torch.float32, device=device)
    mask32 = asm32.vector(bc_mask(W.ndofs, bc))
    g64 = torch.as_tensor(bc_vector(W.ndofs, bc), dtype=torch.float64,
                          device=device)
    zero = torch.zeros(W.ndofs, dtype=torch.float32, device=device)
    kern = make_ns_sups_kernel("tetrahedron", 1.0 / float(duct_fx["Re"]))
    out = solve_newton_bcsr(
        kern, asm32.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm32.arrays,
        mask32, g64.float(), zero, rtol=1e-10, atol=1e-10, max_it=30,
        ksp_rtol=1e-6)
    n0 = float(torch.linalg.vector_norm(
        asm32.bc_residual(kern, zero, mask32, g64.float())))
    rres = refine_newton_bcsr(
        kern, asm32.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm32.arrays,
        asm_arrays_in(asm32.arrays, mesh, torch.float64), mask32, g64,
        out.x, n0, 1e-8, 0.0, 12, 1e-2)
    rel = _rel(np, rres.x.cpu().numpy(), duct_fx["w"])
    print(f"duct SUPS NS Re=20 float32 + refinement: "
          f"{time.perf_counter() - t0:.2f} s, f32 Newton its {out.iters} "
          f"(|F| {out.resnorm:.3e}), refinement steps {rres.iters}, rows "
          f"[|F|, FGMRES its, |r|] {rres.history.tolist()}, rel-L2 vs "
          f"duct_ns.npz {rel:.3e}", flush=True)
    _bar(rres.converged and rel < 1e-6,
         "duct_ns.npz rel-L2 < 1e-6 in float32 with refinement")

    t0 = time.perf_counter()
    # the reference's domain length >= 4 (SURVEY.md:234) and cells no
    # larger than its h = 0.1 (BASELINE.json:7): at 10 cells across
    # (h = 0.1 exactly) P1-P1 sits at rel-L2 0.146 in the JAX package as
    # in the port, above tests/test_stokes_duct.py's 0.12, which that test
    # sets at 12 cells across; so 12 across (h = 1/12), 48 along
    r = duct_stokes.solve_duct(12, 48, length=4.0, device=device)
    pts = r.mesh.points
    uex = square_duct_profile(pts[:, 1], pts[:, 2]) / square_duct_mean()
    err = float(np.sqrt(np.mean((r.u[:, 0] - uex) ** 2))
                / np.sqrt(np.mean(uex ** 2)))
    trans = float(np.abs(r.u[:, 1:]).max() / np.abs(r.u[:, 0]).max())
    print(f"duct Stokes (12, 48, L=4): {time.perf_counter() - t0:.2f} s, "
          f"{4 * len(pts)} dofs, FGMRES its {r.ksp_iters}, rel-L2 vs the "
          f"developed profile {err:.4f}, transverse/axial {trans:.4f}",
          flush=True)
    _bar(r.converged and err < 0.12 and trans < 0.05,
         "duct Stokes: developed profile < 0.12, transverse < 5%")

    t0 = time.perf_counter()
    mesh, W, u, p, res = stokes_channel.solve_stokes_channel(
        img, float(channel_fx["ratio"]), float(channel_fx["lc"]),
        device=device)
    rel = _rel(np, res.x.cpu().numpy(), channel_fx["w"])
    print(f"Stokes channel lc={float(channel_fx['lc']):g}: "
          f"{time.perf_counter() - t0:.2f} s, {W.ndofs} dofs, FGMRES its "
          f"{res.iters} (fixture {int(channel_fx['iters'])}), rel-L2 vs "
          f"stokes_channel.npz {rel:.3e}", flush=True)
    _bar(res.converged and rel < 1e-6, "stokes_channel.npz rel-L2 < 1e-6")
    bcsr_spmv_yardstick(torch, np, W, device)


def bcsr_spmv_yardstick(torch, np, W, device):
    """For information: ``bcsr_matvec`` on the Stokes channel's matrix
    against ``torch.sparse_bsr_tensor`` @ x on the same values, both L2
    flushed, beside the bytes bound (values, x and y once, the int64
    column and row ids)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (
        assembler_for_mixed, bcsr_matvec)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes import (
        make_stokes_kernel)

    asm = assembler_for_mixed(W, device=device)
    pat, a = asm.pattern, asm.arrays
    V = asm.matrix_values(make_stokes_kernel(
        "tetrahedron", nu=1.0, mu_T_coeff=DEFAULT.stab.stokes_mu_T_coeff),
        asm.vector(np.zeros(W.ndofs)))
    x = asm.vector(np.random.default_rng(0).standard_normal(W.ndofs))
    A = torch.sparse_bsr_tensor(
        torch.as_tensor(pat.indptr, dtype=torch.int64, device=device),
        a.indices, V, size=(W.ndofs, W.ndofs))
    y = bcsr_matvec(a, pat.n_rows, V, x)
    y_lib = (A @ x[:, None])[:, 0]
    torch.cuda.synchronize()
    err = float((y - y_lib).abs().max())
    flush = L2Flush(torch, device)
    ms = time_flushed_ms(lambda: bcsr_matvec(a, pat.n_rows, V, x), flush)
    lib_ms = time_flushed_ms(lambda: A @ x[:, None], flush)
    nbytes = (V.numel() * V.element_size() + 2 * W.ndofs * x.element_size()
              + 2 * pat.nnzb * 8)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"BCSR SpMV (Stokes channel, {pat.nnzb} blocks of 4x4, f64; for "
          f"information): bcsr_matvec {ms:.4f} ms, torch.sparse_bsr_tensor "
          f"{lib_ms:.4f} ms, bytes bound {bound:.4f} ms; max abs diff "
          f"{err:.2e}", flush=True)
    del flush


def run_dfg2d(torch, np, cli):
    """Phase 9: DFG 2D-1 through ``dfg2d.main(["0.35"])``, at the scale
    tests/test_dfg.py holds to the literature values."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import dfg2d

    r = cli.in_process("dfg2d")
    wall = cli.walls["dfg2d"]
    print(f"DFG 2D-1 scale 0.35: {wall:.2f} s wall, {r.mesh.n_nodes} nodes, "
          f"{3 * r.mesh.n_nodes} dofs, Newton steps per rung {r.rung_iters}; "
          f"Cd {r.cd:.6f} ({r.cd_err_pct:+.3f}%), Cl {r.cl:.7f} "
          f"({r.cl_err_pct:+.3f}%); surface Cd {r.cd_surface:.6f}, Cl "
          f"{r.cl_surface:.7f}; wall split "
          f"{json.dumps({k: round(v, 3) for k, v in r.timings.items()})}",
          flush=True)
    cd_ref, cl_ref = dfg2d.CD_REF, dfg2d.CL_REF
    _bar(r.converged and np.isfinite(r.u).all() and np.isfinite(r.p).all(),
         "DFG 2D converged")
    _bar(abs(r.cd - cd_ref) / cd_ref < 0.01, "Cd within 1% of 5.57953523384")
    _bar(abs(r.cl - cl_ref) / cl_ref < 0.03, "Cl within 3% of 0.010618948146")
    _bar(abs(r.cd_surface - cd_ref) / cd_ref < 0.03
         and abs(r.cl_surface - cl_ref) / cl_ref < 0.03,
         "surface-integral Cd and Cl within 3%")


def run_taylor_hood(torch, np, device):
    """Phase 10: the Taylor-Hood duct, Schur solve on the card against
    the host LU."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.duct_stokes_th import (
        solve_duct_th)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.exact import (
        square_duct_mean, square_duct_profile)

    def rel_err(r):
        uex = square_duct_profile(r.u_coords[:, 1], r.u_coords[:, 2]) \
            / square_duct_mean()
        return float(np.sqrt(np.mean((r.u[:, 0] - uex) ** 2))
                     / np.sqrt(np.mean(uex ** 2)))

    t0 = time.perf_counter()
    rs = solve_duct_th(6, 12, inlet="poiseuille", device=device)
    torch.cuda.synchronize()
    t_schur = time.perf_counter() - t0
    t0 = time.perf_counter()
    rl = solve_duct_th(6, 12, inlet="poiseuille", method="lu", device=device)
    t_lu = time.perf_counter() - t0
    # null pivots (rim pressure dofs with every coupled velocity dof
    # constrained): the LU pins them to 0, the Schur solve leaves them
    # undetermined
    live = rl.p != 0.0
    es, el = rel_err(rs), rel_err(rl)
    du, dp = _rel(np, rs.u, rl.u), _rel(np, rs.p[live], rl.p[live])
    print(f"Taylor-Hood duct (6, 12): {rs.space.ndofs} dofs; Schur "
          f"{t_schur:.2f} s, outer FGMRES its {rs.outer_iters}, inner CG its "
          f"{rs.inner_iters}, rel-L2 vs the developed profile {es:.4f}; LU "
          f"{t_lu:.2f} s, {el:.4f}; Schur vs LU rel-L2 u {du:.3e}, p "
          f"{dp:.3e} on {int(live.sum())} of {len(live)} pressure dofs",
          flush=True)
    _bar(np.isfinite(rs.u).all() and es < 0.06 and el < 0.06,
         "both methods within 0.06 of the developed profile")
    _bar(du < 1e-6 and dp < 1e-6, "Schur and LU within rel-L2 1e-6")

    t0 = time.perf_counter()
    r = solve_duct_th(12, 24, length=2.0, inlet="poiseuille", device=device)
    torch.cuda.synchronize()
    print(f"Taylor-Hood duct (12, 24, L=2), for information: "
          f"{r.space.ndofs} dofs, Schur {time.perf_counter() - t0:.2f} s, "
          f"outer {r.outer_iters}, inner {r.inner_iters}, rel-L2 vs the "
          f"developed profile {rel_err(r):.4f}", flush=True)


DFG3D_PAIRS = tuple(p for p in PAIRS if p[3] == "main")


def check_ugn_soa(torch, np, mesh, device, n_cells: int = 4096):
    """``make_ugn_soa`` on the card against the per-cell UGN kernel and
    ``jacfwd`` of it, on the first cells of ``mesh`` with a seeded state
    (one cell in four at rest)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_ugn_kernel)

    kern = make_ns_ugn_kernel("tetrahedron", 1e-3)
    coords = torch.as_tensor(mesh.points[mesh.cells[:n_cells]], device=device)
    w = np.random.default_rng(5).standard_normal((n_cells, 16)) * 0.3
    w.reshape(n_cells, 4, 4)[::4, :, :3] = 0.0
    w = torch.as_tensor(w, device=device)
    coordsT = coords.permute(1, 2, 0).reshape(12, n_cells).contiguous()
    r = kern.res_soa(coordsT, w.T.contiguous()).T
    J = kern.jac_soa(coordsT, w.T.contiguous()).permute(2, 0, 1)
    r_ref = torch.func.vmap(kern)(coords, w)
    J_ref = torch.func.vmap(
        lambda c, we: torch.func.jacfwd(lambda ww: kern(c, ww))(we))(coords, w)
    torch.cuda.synchronize()
    er = float(torch.linalg.vector_norm(r - r_ref)
               / torch.linalg.vector_norm(r_ref))
    eJ = float(torch.linalg.vector_norm(J - J_ref)
               / torch.linalg.vector_norm(J_ref))
    print(f"UGN SoA on {n_cells} pillar cells: res_soa rel {er:.3e}, "
          f"jac_soa vs jacfwd rel {eJ:.3e} (bar 1e-10)", flush=True)
    _bar(bool(torch.isfinite(J).all()) and er < 1e-10 and eJ < 1e-10,
         "make_ugn_soa equals the per-cell kernel and its jacfwd")


def run_dfg3d(torch, np, device):
    """Phase 11: K1 on the pillar operator's levels, then DFG 3D-1Z on the
    layered path, uncut.  Returns (kernel checks, K1 launches by pair)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import dfg3d
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        matrix_values_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.mg import (
        galerkin_levels)

    t0 = time.perf_counter()
    mesh, _W, lp, mask, g, hier, _obst = dfg3d._fine_setup(
        0.5, 1.0, 0.15, 3, device)
    a = lp.arrays
    kern = make_ns_sups_kernel("tetrahedron", nu=dfg3d.NU,
                               transposed_stab=False)
    vals = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, a, g)
    levels = galerkin_levels(hier, vals, a.cols, a.row_ids, a.row_ptr,
                             a.diag_pos, mask, lp.n2d, lp.n_planes)
    torch.cuda.synchronize()
    print(f"K1 shapes on the pillar: dofs {lp.ndofs}; (E, Lp, n2d) per "
          f"V-cycle level "
          f"{[(op.values.shape[3], op.n_planes, op.n2d) for op in levels]}; "
          f"set-up {time.perf_counter() - t0:.2f} s", flush=True)
    checks = check_levels(torch, np, levels, DFG3D_PAIRS, device)
    del levels, vals
    check_ugn_soa(torch, np, mesh, device)

    layered_spmv.reset_launches()
    t0 = time.perf_counter()
    r = dfg3d.solve_dfg3d_fine(0.5, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(layered_spmv.LAUNCHES_BY_DTYPES)
    by_pair = _by_pair(launches)
    for nu, its, ksp, fnorm, t in r.rungs:
        print(f"DFG 3D rung nu={nu:g}: Newton steps {its}, FGMRES its {ksp}, "
              f"|F| {fnorm:.3e}, {t:.2f} s", flush=True)
    print(f"DFG 3D-1Z scale 0.5: {wall:.2f} s wall, {r.mesh.n_nodes} nodes; "
          f"Cd {r.cd:.5f} ({100 * (r.cd - 6.18533) / 6.18533:+.2f}%), Cl "
          f"{r.cl:.6f}; surface Cd {r.cd_surface:.5f}, Cl "
          f"{r.cl_surface:.6f}; K1 launches {layered_spmv.LAUNCHES} "
          f"{by_pair}", flush=True)
    _bar(r.converged and np.isfinite(r.u).all() and np.isfinite(r.p).all(),
         "DFG 3D converged")
    _bar(abs(r.cd - 6.18533) / 6.18533 < 0.02, "Cd within 2% of 6.18533")
    _bar(0.009401 / 3 < r.cl < 3.5 * 0.009401,
         "Cl in (0.003134, 0.032904)")
    missing = [c["pair"] for c in checks if launches.get(
        tuple(getattr(torch, n) for n in c["pair"]), 0) == 0]
    _bar(not missing, f"the DFG 3D solve launched K1 for every pair "
                      f"(missing {missing})")
    return checks, launches


def _print_solution(sol, what: str, wall: float) -> None:
    print(f"{what}: {wall:.2f} s wall, timings "
          f"{json.dumps({k: round(v, 4) for k, v in sol.timings.items()})}",
          flush=True)
    for name, h in sol.newton_history.items():
        print(f"{what} {name}: Newton steps {len(h)}, FGMRES its "
              f"{[int(r[2]) for r in h]}, lambda {[float(r[1]) for r in h]}, "
              f"|F| {[float('%.3e' % r[0]) for r in h]}", flush=True)


def run_apps_route(torch, np, img, device):
    """Phase 12: the coarse-to-fine route the apps take (the default
    ``coarse_lc=0.1``)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        solve_ns_flow)

    layered_spmv.reset_launches()
    t0 = time.perf_counter()
    sol = solve_ns_flow(RE, img, RATIO, LC, device=device)
    torch.cuda.synchronize()
    _print_solution(sol, "apps' route (coarse_lc=0.1 -> lc=0.04)",
                    time.perf_counter() - t0)
    fine = sol.newton_history["fine_ns"]
    t = sol.timings
    w_ref = np.load(FIXTURE)["w"]
    rel = _rel(np, sol.w, w_ref) if sol.w.shape == w_ref.shape else np.inf
    print(f"apps' route: interpolate {t.get('interpolate', -1):.3f} s, "
          f"fine_setup {t.get('fine_setup', -1):.3f} s, fine_ns "
          f"{t['fine_ns']:.3f} s; fine Newton steps {len(fine)}, FGMRES its "
          f"{[int(r[2]) for r in fine]}; Stokes FGMRES its {sol.stokes_iters}; "
          f"K1 launches {layered_spmv.LAUNCHES}; rel-L2 vs "
          f"channel_ns_prod.npz {rel:.3e}", flush=True)
    _bar("interpolate" in t and "fine_setup" in t,
         "the solve ran the coarse-to-fine branch")
    _bar(sol.converged and np.isfinite(sol.w).all(), "apps' route converged")
    _bar(len(fine) >= 1, "at least one fine Newton step")
    _bar(rel < 1e-6, "apps' route rel-L2 < 1e-6 of channel_ns_prod.npz")
    _bar(layered_spmv.LAUNCHES > 0, "the apps' route launched K1")


RE_LADDER, RE_LADDER_WARM = 60.0, 70.0


def run_reynolds_ladder(torch, np, img, device):
    """Phase 13: the coarse mesh's Reynolds ladder (above Re 50), and the
    warm path against the cold one above it."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        solve_ns_flow)

    sols = {}
    for what, re, warm in (("Re=60 cold", RE_LADDER, None),
                           ("Re=70 warm", RE_LADDER_WARM, "Re=60 cold"),
                           ("Re=70 cold", RE_LADDER_WARM, None)):
        t0 = time.perf_counter()
        sol = solve_ns_flow(re, img, RATIO, LC, device=device,
                            warm=sols.get(warm))
        torch.cuda.synchronize()
        _print_solution(sol, what, time.perf_counter() - t0)
        rungs = [k for k in sol.newton_history if k.startswith("coarse_ns")]
        print(f"{what}: ladder rungs {rungs}, fine Newton steps "
              f"{sol.newton_iters}, |F| {sol.newton_resnorm:.3e}, converged "
              f"{sol.converged}", flush=True)
        _bar(sol.converged and np.isfinite(sol.w).all(), f"{what} converged")
        if warm is None:
            _bar(len(rungs) > 1, f"{what} climbed a ladder ({len(rungs)} "
                                 f"rungs)")
        else:
            _bar(not rungs, f"{what} ran no coarse phase")
        sols[what] = sol
    rel = _rel(np, sols["Re=70 warm"].w, sols["Re=70 cold"].w)
    print(f"Re=70 warm vs cold: rel-L2 {rel:.3e} (bar 1e-6)", flush=True)
    _bar(rel < 1e-6, "warm and cold Re=70 within rel-L2 1e-6")


SHARD_TOLS = dict(rtol=1e-10, atol=1e-10, max_it=30, ksp_rtol=1e-10)
# the sharded solve's V-cycle keeps f64 values: the outer operator and the
# V-cycle's residuals read f64 x, its smoothers f32 x
SHARD_PAIRS = tuple(p for p in PAIRS if p[0] == "float64")


def check_slab_operand(torch, np, kern, lp, mask_p, g_p, w0_np, device):
    """K1 at the shapes the sharded solve gives it, against its plain
    version.  The slab's operand (``SlabOperand.inner``) has the slab's
    planes plus two halo planes with zero value rows and the halo-extended
    mask; it goes through ``check_levels`` for both of the solve's type
    pairs.  Then the whole wrapper (halo fetch, K1, interior kept) is held
    against the plain version of the operand without halo planes.  The
    values are the slab assembly's at the solve's start.  Call it inside
    the process group.  Returns the checks."""
    import types

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.layered_shard import (
        SlabOperand, _halo_values, halo_extend, make_slab_assembly,
        shard_layered_inputs)

    arrays, slab, meta, (mask_s, _g_s, w0_s) = shard_layered_inputs(
        lp, mask_p, g_p, w0_np, None, device)
    n2d, bs, Lq = lp.n2d, lp.bs, meta["Lq"]
    _, values_fn = make_slab_assembly(kern, n2d, Lq, bs, lp.E)
    values = values_fn(slab, w0_s)
    mask_ext = halo_extend(mask_s, n2d * bs)
    inner = SlabOperand(values, arrays.cols, arrays.row_ptr, n2d,
                        mask_ext).inner
    level = types.SimpleNamespace(
        values=_halo_values(values), cols=arrays.cols, row_ids=arrays.row_ids,
        row_ptr=arrays.row_ptr, mask=mask_ext, n2d=n2d, n_planes=Lq + 2)
    print(f"K1 shapes on the slab: (E, planes, n2d) "
          f"{(lp.E, Lq + 2, n2d)}, {Lq} planes of values and two zero halo "
          f"planes", flush=True)
    _bar(inner.Lp == Lq + 2 and inner.masked
         and not bool(level.values[..., 0].any())
         and not bool(level.values[..., -1].any()),
         "the slab operand has the slab's planes and two zero halo planes")
    checks = check_levels(
        torch, np, [level], SHARD_PAIRS, device,
        on_levels={(v, x): range(1) for v, x, _, _ in SHARD_PAIRS})

    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        mask_s.numel()), device=device)
    for vname, xname, tol, _ in SHARD_PAIRS:
        vdt, xdt = getattr(torch, vname), getattr(torch, xname)
        A = SlabOperand(values, arrays.cols, arrays.row_ptr, n2d, mask_ext,
                        None, vdt)
        whole = layered_spmv.LayeredOperand(
            values, arrays.cols, arrays.row_ptr, n2d, mask=mask_s, dtype=vdt)
        layered_spmv.reset_launches()
        y_k = A(x.to(xdt))
        torch.cuda.synchronize()
        launched = layered_spmv.LAUNCHES
        y_p = layered_spmv.layered_matvec_plain(whole, x.to(xdt))
        rel = float(torch.linalg.vector_norm(y_k.double() - y_p.double())
                    / torch.linalg.vector_norm(y_p.double()))
        print(f"SlabOperand ({vname} values, {xname} x) vs the plain version "
              f"without halo planes: rel-L2 {rel:.3e} (tol {tol:g}), K1 "
              f"launches {launched}", flush=True)
        _bar(launched == 1 and y_k.shape == y_p.shape
             and bool(torch.isfinite(y_k).all()) and rel <= tol,
             f"SlabOperand ({vname} values, {xname} x) launches K1 and "
             f"equals the plain version")
    return checks


def run_sharded(torch, np, img, device):
    """Phase 14: the multi-device layer on one card.  Returns (K1's checks
    on the slab operand, the sharded solve's K1 launches by pair)."""
    import torch.distributed as dist

    import __graft_entry_torch__ as graft
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        build_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        _setup_layered, generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import comm
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.layered_shard import (
        gather_dofs, pad_mask_g, padded_planes, sharded_newton_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (
        solve_newton_layered)

    # entry() on the card against the same function on CPU tensors
    fn_c, args_c = graft.entry(device)
    fn_h, args_h = graft.entry("cpu")
    seeded = np.random.default_rng(7).standard_normal(args_h[0].shape) * 0.1
    for what, w in (("example", args_h[0].numpy()), ("seeded", seeded)):
        rn_c, z_c = fn_c(torch.as_tensor(w, device=device))
        rn_h, z_h = fn_h(torch.as_tensor(w))
        e_rn = abs(float(rn_c) - float(rn_h)) / float(rn_h)
        e_z = _rel(np, z_c.cpu().numpy(), z_h.numpy())
        print(f"entry() on the card vs the CPU, {what} state: |r| rel "
              f"{e_rn:.3e}, z rel-L2 {e_z:.3e} (bar 1e-10)", flush=True)
        _bar(z_c.is_cuda and e_rn < 1e-10 and e_z < 1e-10,
             f"entry() on the card equals the CPU's ({what} state)")

    # the same lc=0.04 problem for both solves, from the same start
    t0 = time.perf_counter()
    inlet1, inlet2 = solve_inlet_profiles(img, RATIO, DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, LC, DEFAULT)
    st = _setup_layered(mesh, inlet1, inlet2, torch.float64,
                        DEFAULT.solver.mg_levels, device)
    lp1 = st.lp
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / RE,
                               C_I=DEFAULT.stab.C_I)
    mask_np, g_np = st.mask.cpu().numpy(), st.g.cpu().numpy()
    w0_np = mask_np * (0.5 * np.load(FIXTURE)["w"]) + (1.0 - mask_np) * g_np
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    ref = solve_newton_layered(
        kern, lp1.n2d, lp1.n_planes, lp1.bs, lp1.arrays, st.mask, st.g,
        torch.as_tensor(w0_np, device=device), lp1.E,
        SHARD_TOLS["rtol"], SHARD_TOLS["atol"], SHARD_TOLS["max_it"],
        SHARD_TOLS["ksp_rtol"], 50, 40, "mg_cheby", st.mg)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0

    rendezvous = os.path.join(ROOT, "build", "chip_smoke",
                              f"rendezvous_{os.getpid()}")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    comm.init_process_group(device, f"file://{rendezvous}", 1, 0)
    try:
        one = torch.ones(4, device=device)
        dist.all_reduce(one)
        torch.cuda.synchronize()
        _bar(dist.get_backend() == "nccl" and dist.get_world_size() == 1
             and bool((one == 1.0).all()),
             "a world-size-1 nccl group all-reduces on the card")
        t0 = time.perf_counter()
        W = st.space
        n2d, Lp, _ = mesh.layered
        lp = build_layered(W, n2d, padded_planes(Lp, 1), device="cpu")
        mask_p, g_p = pad_mask_g(mask_np, g_np, lp.ndofs)
        t_host = time.perf_counter() - t0
        slab_checks = check_slab_operand(torch, np, kern, lp, mask_p, g_p,
                                         w0_np, device)
        layered_spmv.reset_launches()
        t0 = time.perf_counter()
        out = sharded_newton_layered(
            kern, lp, mask_p, g_p, w0_np, device=device, pc="mg",
            mg_levels=DEFAULT.solver.mg_levels, **SHARD_TOLS)
        x = gather_dofs(out.x)
        torch.cuda.synchronize()
        t_shard = time.perf_counter() - t0
        launches = dict(layered_spmv.LAUNCHES_BY_DTYPES)
        total = layered_spmv.LAUNCHES
    finally:
        comm.destroy_process_group()
        if os.path.exists(rendezvous):
            os.remove(rendezvous)

    rel = _rel(np, x.cpu().numpy(), ref.x.cpu().numpy())
    its_ref = [int(r[2]) for r in ref.history]
    its = [int(r[2]) for r in out.history]
    by_pair = _by_pair(launches)
    print(f"sharded layered Newton (world size 1, nccl) on {lp.ndofs} dofs: "
          f"problem set-up {t_setup:.2f} s, host pattern {t_host:.2f} s, "
          f"solve {t_shard:.2f} s, Newton steps {out.iters}, FGMRES its "
          f"{its}, |F| {out.resnorm:.3e}; single process (structured "
          f"assembly, mg_cheby): {t_ref:.2f} s, Newton steps {ref.iters}, "
          f"FGMRES its {its_ref}, |F| {ref.resnorm:.3e}; rel-L2 between them "
          f"{rel:.3e} (bar 1e-8); K1 launches in the sharded solve {total} "
          f"{by_pair}", flush=True)
    _bar(out.converged and ref.converged, "both solves converged")
    _bar(x.is_cuda and out.x.numel() == lp.ndofs,
         "the sharded solution is the one slab, on the card")
    _bar(rel < 1e-8, "sharded and single-process within rel-L2 1e-8")
    _bar(out.iters == ref.iters, "the same Newton step count")
    _bar(len(its) == len(its_ref)
         and all(abs(a - b) <= 1 for a, b in zip(its, its_ref)),
         "FGMRES counts within 1 per step")
    _bar(total > 0, "the sharded solve launched K1")
    missing = [c["pair"] for c in slab_checks if launches.get(
        tuple(getattr(torch, n) for n in c["pair"]), 0) == 0]
    _bar(not missing, f"the sharded solve launched K1 for every pair checked "
                      f"on the slab (missing {missing})")
    return slab_checks, launches


def k2_bytes(op) -> int:
    """Bytes one K2 call must move: the three value slices and the block
    inverses (value type) once, the mask and r read once and x written
    once (iterate type), and the pair tables (cols, row_ptr)."""
    vsize, asize = op.values.element_size(), op.mask.element_size()
    ndofs = op.Lp * op.n2d * 4
    return ((3 * op.E + op.n2d) * op.Lp * 16 * vsize + 3 * ndofs * asize
            + 8 * op.E + 8 * (op.n2d + 1))


def k2_bound(op):
    """(bound_ms, bound_by): the larger of the bytes over the H100's
    3.35 TB/s and the sweep's FLOP over its peak for the iterate's type
    outside the tensor cores (67 TFLOP/s f32, 34 TFLOP/s f64).  Per plane
    and direction: the coupling product (2 FLOP per value of a slice) and
    ``inner_sweeps`` products with V0, each stage with a 4x4 block
    inverse per row (2 * 16 FLOP)."""
    import torch

    t_bytes = k2_bytes(op) / HBM_BYTES_PER_S * 1e3
    stages = 1 + op.inner_sweeps
    per_plane = stages * (2 * 16 * op.E + 2 * 16 * op.n2d)
    flops = (2 if op.symmetric else 1) * op.Lp * per_plane
    peak = 34e12 if op.adtype == torch.float64 else 67e12
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_problem(torch, np, img, device):
    """The lc=0.04 channel's layered set-up with its multigrid hierarchy
    and the Stokes and NS kernels: what phase 15 and profile_torch_k2.py
    build K2's levels from."""
    from types import SimpleNamespace

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        _setup_layered, generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes import (
        make_stokes_kernel)

    inlet1, inlet2 = solve_inlet_profiles(img, RATIO, DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, LC, DEFAULT)
    st = _setup_layered(mesh, inlet1, inlet2, torch.float64,
                        DEFAULT.solver.mg_levels, device)
    stokes_k = make_stokes_kernel(
        "tetrahedron", nu=1.0, mu_T_coeff=DEFAULT.stab.stokes_mu_T_coeff)
    ns_k = make_ns_sups_kernel("tetrahedron", nu=1.0 / RE,
                               C_I=DEFAULT.stab.C_I)
    states = {"Stokes J(0)": (stokes_k, torch.zeros_like(st.mask)),
              "NS J(w*)": (ns_k, torch.as_tensor(np.load(FIXTURE)["w"],
                                                 device=device))}
    return SimpleNamespace(st=st, stokes_k=stokes_k, states=states)


def k2_levels(problem, state: str):
    """The Galerkin levels (solve/mg.py::LevelOperator) of ``problem`` at
    ``state`` ("Stokes J(0)" or "NS J(w*)"); K2 smooths all but the
    coarsest."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        matrix_values_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.mg import (
        galerkin_levels)

    st = problem.st
    lp, a = st.lp, st.lp.arrays
    kern, w = problem.states[state]
    vals = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, a, w)
    return galerkin_levels(st.mg, vals, a.cols, a.row_ids, a.row_ptr,
                           a.diag_pos, st.mask, lp.n2d, lp.n_planes)


def k2_plan_line(K, ms: float, chain_ms: float) -> str:
    """Phase 15's account of one K2 operand's launch plan and its time per
    stage beside the floor of its barrier chain."""
    p = K.plan
    return (f"cluster {p.cluster} x {p.threads} threads (split {p.split}), "
            f"{p.max_rows} rows and {p.max_pairs} pairs a block, "
            f"{p.smem_bytes} B shared memory a block, "
            f"{'value ring ' + str(p.slots) if p.staged else 'values from memory'}"
            f"; {K.stages} stages, {ms / K.stages * 1e3:.3f} us a stage; "
            f"the cluster barriers alone {chain_ms:.4f} ms "
            f"({chain_ms / (K.stages + 1) * 1e3:.3f} us a stage)")


def plan_record(plan) -> dict:
    """K2's launch plan as the kernels line reports it."""
    return dict(cluster=plan.cluster, slots=plan.slots, split=plan.split,
                threads=plan.threads, rows=plan.max_rows,
                pairs=plan.max_pairs, bytes=plan.smem_bytes)


def check_k2_levels(torch, np, levels, state, rng, flush, checks):
    """K2 against its plain version on every smoothed level of ``levels``
    (all but the coarsest, which is solved densely) at ``state``, for
    each pair of ``K2_PAIRS``: its time with L2 flushed, its bound, its
    launch plan and its barrier chain's floor; at level 0 of a Stokes
    matrix also the plain version's time, all of it kept in
    ``checks[pair]``, whose ``errs`` gathers the max abs errors."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import plane_gs

    print(f"K2 shapes at {state}: (E, Lp, n2d) per smoothed level "
          f"{[(op.values.shape[3], op.n_planes, op.n2d) for op in levels[:-1]]}"
          f" (the coarsest, {levels[-1].n2d * levels[-1].n_planes * 4} "
          f"dofs, is solved densely)", flush=True)
    for k, op in enumerate(levels[:-1]):
        r = torch.as_tensor(rng.standard_normal(op.mask.numel()),
                            device=op.values.device)
        for vname, aname, tol, _ in K2_PAIRS:
            K = plane_gs.PlaneGSOperand(
                op.values, op.cols, op.row_ptr, op.diag_pos, op.mask,
                op.n2d, dtype=getattr(torch, vname))
            x_k = K(r)
            torch.cuda.synchronize()
            x_p = plane_gs.plane_gs_plain(K, r)
            torch.cuda.synchronize()
            diff = x_k - x_p
            max_abs = float(diff.abs().max())
            rel = float(torch.linalg.vector_norm(diff)
                        / torch.linalg.vector_norm(x_p))
            if not torch.isfinite(x_k).all() or rel > tol:
                raise RuntimeError(
                    f"K2 ({vname} values, {aname} iterate) disagrees "
                    f"with its plain version at {state} on level {k}: "
                    f"rel-L2 {rel:.3e} > {tol:g}")
            c = checks[(vname, aname)]
            c["errs"].append(max_abs)
            ms = time_flushed_ms(lambda: K(r), flush)
            chain_ms = time_ms(K.barrier_chain, 10)
            bound, bound_by = k2_bound(K)
            line = (f"K2 ({vname} values, {aname} iterate) {state} level "
                    f"{k}: rel-L2 {rel:.3e} (tol {tol:g}), max abs err "
                    f"{max_abs:.3e}; L2-flushed {ms:.4f} ms, bound "
                    f"{bound:.4f} ms ({bound_by}; {bound / ms:.2%} of "
                    f"it)")
            # the plain version (a Python loop over planes) is timed
            # where the kernels line reads it: level 0 of J(0)
            if k == 0 and state.startswith("Stokes"):
                plain_ms = time_ms(
                    lambda: plane_gs.plane_gs_plain(K, r), 5)
                line += f", plain {plain_ms:.4f} ms"
                c.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=bound_by, cluster=K.plan.cluster,
                         chain_ms=chain_ms, plan=plan_record(K.plan))
            print(f"{line}; {k2_plan_line(K, ms, chain_ms)}", flush=True)


def run_plane_gs(torch, np, img, device):
    """Phase 15: K2 against its plain version on every smoothed V-cycle
    level of the lc=0.04 channel, at the Stokes matrix J(0) and at the NS
    Jacobian of the stored solution, for both type pairs, with its
    yardsticks, its launch plan and its barrier chain's floor; then the
    Stokes solve with pc="mg" and "mg_bf16" against the "mg_cheby_bf16"
    one.  Returns (checks by pair, K2 launches of the mg_bf16 solve by
    pair)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import plane_gs
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (
        solve_linear_layered)

    t0 = time.perf_counter()
    problem = k2_problem(torch, np, img, device)
    st = problem.st
    lp, a = st.lp, st.lp.arrays
    flush = L2Flush(torch, device)
    rng = np.random.default_rng(3)
    checks = {p[:2]: dict(errs=[]) for p in K2_PAIRS}
    for state in problem.states:
        levels = k2_levels(problem, state)
        check_k2_levels(torch, np, levels, state, rng, flush, checks)
        del levels
    del flush
    print(f"K2 checks: {time.perf_counter() - t0:.2f} s", flush=True)

    sols, launches = {}, {}
    for pc in ("mg_cheby_bf16", "mg", "mg_bf16"):
        plane_gs.reset_launches()
        layered_spmv.reset_launches()
        t0 = time.perf_counter()
        res = solve_linear_layered(
            problem.stokes_k, lp.n2d, lp.n_planes, lp.bs, a, st.mask, st.g,
            lp.E, 1e-8, DEFAULT.solver.ksp_restart, pc, st.mg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[pc] = dict(plane_gs.LAUNCHES_BY_DTYPES)
        print(f"Stokes lc={LC:g} pc={pc}: FGMRES its {res.iters}, converged "
              f"{res.converged}, {wall:.2f} s wall; K2 launches "
              f"{plane_gs.LAUNCHES} {_by_pair(launches[pc])}, K1 launches "
              f"{layered_spmv.LAUNCHES}", flush=True)
        _bar(res.converged and bool(torch.isfinite(res.x).all()),
             f"the pc={pc} Stokes solve converged")
        sols[pc] = res.x.cpu().numpy()
    for pc in ("mg", "mg_bf16"):
        rel = _rel(np, sols[pc], sols["mg_cheby_bf16"])
        print(f"Stokes pc={pc} vs pc=mg_cheby_bf16: rel-L2 {rel:.3e} (bar "
              f"1e-6)", flush=True)
        _bar(rel < 1e-6, f"the pc={pc} and mg_cheby_bf16 Stokes solves "
                         f"agree to rel-L2 1e-6")
    for (vname, aname), pc in (((v, x), "mg" if p == "main" else p)
                               for v, x, _, p in K2_PAIRS if p != "f32"):
        key = (getattr(torch, vname), getattr(torch, aname))
        _bar(launches[pc].get(key, 0) > 0,
             f"the pc={pc} Stokes solve launched K2 ({vname}, {aname})")
    return checks, launches["mg_bf16"]


def run_f32_main_path(torch, np, img, device, f64_wall):
    """Phase 16: the main path in float32 with refinement (an f64
    residual on f64 geometry).  Returns (K1, K2) launches by pair."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        layered_arrays_in, matrix_values_layered, residual_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        _setup_layered, solve_ns_flow)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import plane_gs

    scfg = DEFAULT.solver
    layered_spmv.reset_launches()
    plane_gs.reset_launches()
    t0 = time.perf_counter()
    sol = solve_ns_flow(RE, img, RATIO, channel_mesh_size=LC, coarse_lc=LC,
                        dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = dict(layered_spmv.LAUNCHES_BY_DTYPES)
    k2 = dict(plane_gs.LAUNCHES_BY_DTYPES)

    print(f"float32 solve_ns_flow + refinement: {wall:.2f} s wall (phase "
          f"3's float64 solve: {f64_wall:.2f} s), timings "
          f"{json.dumps({k: round(v, 4) for k, v in sol.timings.items()})}",
          flush=True)
    print(f"float32 Stokes FGMRES its {sol.stokes_iters}; fine Newton its "
          f"{sol.newton_iters}, |F| {sol.newton_resnorm:.3e}, converged "
          f"{sol.base_converged}", flush=True)
    for name, h in sol.newton_history.items():
        print(f"float32 {name}: FGMRES its {[int(r[2]) for r in h]}, lambda "
              f"{[float(r[1]) for r in h]}, |F| "
              f"{[float('%.3e' % r[0]) for r in h]}", flush=True)
    print(f"refined {sol.refined}: {sol.refine_iters} steps (budget "
          f"{scfg.refine_max_it}), |F| {sol.refine_resnorm:.3e}, converged "
          f"{sol.converged}", flush=True)
    print(f"K1 launches in the float32 solve: {layered_spmv.LAUNCHES} "
          f"{_by_pair(k1)}; K2: {plane_gs.LAUNCHES} {_by_pair(k2)}",
          flush=True)

    # what one refinement step costs: an f64 residual on the f64 geometry
    # and an f32 Jacobian, on this problem at the solution
    inlet1, inlet2 = solve_inlet_profiles(img, RATIO, DEFAULT)
    st = _setup_layered(sol.mesh, inlet1, inlet2, torch.float32, 0, device)
    lp = st.lp
    a64 = layered_arrays_in(lp.arrays, sol.mesh, torch.float64)
    geo_bytes = sum(t.numel() * t.element_size() for t in (
        a64.cell_coords, a64.sasm.cell_coords, a64.sasm.coordsT))
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / RE,
                               C_I=DEFAULT.stab.C_I)
    w64 = torch.as_tensor(sol.w.astype(np.float64) + sol.w_lo,
                          device=device)
    w32 = w64.float()
    res_ms = time_ms(lambda: residual_layered(
        kern, lp.n2d, lp.n_planes, lp.bs, a64, w64), 5)
    jac_ms = time_ms(lambda: matrix_values_layered(
        kern, lp.E, lp.n_planes, lp.bs, lp.arrays, w32), 5)
    print(f"a refinement step's assembly: f64 residual {res_ms:.2f} ms, f32 "
          f"Jacobian {jac_ms:.2f} ms (CUDA events, median of 5); the f64 "
          f"geometry {geo_bytes / 2 ** 20:.1f} MiB", flush=True)
    del st, a64

    w_ref = np.load(FIXTURE)["w"]
    w = sol.w.astype(np.float64) + sol.w_lo
    rel = _rel(np, w, w_ref)
    print(f"float32 + refinement: rel-L2 of w + w_lo vs channel_ns_prod.npz "
          f"{rel:.3e} (bar 1e-6); of w alone {_rel(np, sol.w, w_ref):.3e}",
          flush=True)
    _bar(sol.refined and sol.converged and np.isfinite(w).all(),
         "the float32 solve refined and converged")
    _bar(sol.refine_iters <= scfg.refine_max_it,
         f"refinement within refine_max_it = {scfg.refine_max_it} steps")
    _bar(w.shape == w_ref.shape and rel < 1e-6,
         "w + w_lo within rel-L2 1e-6 of channel_ns_prod.npz")
    f32, bf16 = torch.float32, torch.bfloat16
    _bar(k1.get((f32, f32), 0) > 0 and k1.get((bf16, f32), 0) > 0,
         "K1 launched for (float32, float32) and (bfloat16, float32)")
    _bar(k2.get((f32, f32), 0) > 0, "K2 launched for (float32, float32)")
    return k1, k2


APPS_SEEDS_CLI = 50        # streamtrace_cli's grid (streamtrace.py:668)


class _Clock:
    """Host seconds by label of the module functions it wraps.  Every
    wrapped call returns host arrays (numpy), so its device work is done
    when it returns."""

    def __init__(self):
        self.s: dict = {}
        self._undo: list = []

    def wrap(self, module, name: str, label: str, keep=None):
        fn = getattr(module, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                self.s[label] = (self.s.get(label, 0.0)
                                 + time.perf_counter() - t0)
            if keep is not None:
                keep.append(out)
            return out

        setattr(module, name, timed)
        self._undo.append((module, name, fn))

    def take(self) -> dict:
        out, self.s = self.s, {}
        return out

    def restore(self) -> None:
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)
        self._undo = []


def _split(split: dict, wall: float) -> str:
    parts = {k: round(v, 4) for k, v in split.items()}
    parts["other"] = round(wall - sum(split.values()), 4)
    return json.dumps(parts)


def _mb(path: str) -> float:
    return os.path.getsize(path) / 1e6


def _launch_delta(before, after) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n - before.get(k, 0)}


def _check_round_trip(np, base, name, mesh, values, what):
    """The checkpoint ``base`` read back by the port equals the field and
    its mesh bit for bit; returns (the read's seconds, the .h5's MB)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.io.xdmf import (
        read_xdmf_function)

    t0 = time.perf_counter()
    mesh_r, vals = read_xdmf_function(base, name)
    read_s = time.perf_counter() - t0
    want = np.asarray(values, np.float64)
    _bar(vals.dtype == np.float64 and vals.shape == want.shape
         and vals.tobytes() == want.tobytes()
         and np.array_equal(mesh_r.cells, mesh.cells)
         and mesh_r.points.tobytes() == mesh.points.tobytes(),
         f"{what}: {os.path.basename(base)}.h5 read back equals the field "
         f"and mesh bit for bit")
    return read_s, _mb(base + ".h5")


def _parse_svgs(folder, names, what) -> None:
    import xml.etree.ElementTree as ET

    for name in names:
        try:
            ET.parse(os.path.join(folder, name))
        except (OSError, ET.ParseError) as e:
            raise RuntimeError(f"{what}: {name} does not parse ({e})") from e
    _bar(True, f"{what}: {', '.join(names)} parse")


def run_apps(torch, np, img, sol20_phase6, card, device):
    """Phase 17: the port's entry points on the card, through their own
    XDMF write and re-read, trace, figures and CSVs: ``sweep re`` (two
    ``inlet_batch.run_trace_save`` runs), ``streamtrace_cli``,
    ``ns_channel``, ``stokes_channel`` and ``compare_images``.  Returns
    the (K1, K2) launches of the path by pair."""
    from PIL import Image

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (
        compare_images, inlet_batch, ns_channel, stokes_channel,
        streamtrace_cli, sweep)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import plane_gs
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (
        streamtrace)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace.pipeline import (
        for_and_rev_streamtrace)

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke", "apps")
    shutil.rmtree(root, ignore_errors=True)
    dirs = {n: os.path.join(root, n) for n in
            ("sweep", "cli", "ns_channel", "stokes_channel", "compare")}
    for d in dirs.values():
        os.makedirs(d)
    fx = np.load(TRACE_FIXTURE)
    w_ref = np.load(FIXTURE)["w"]
    cwd = os.getcwd()
    clock = _Clock()
    runs, walls, splits, k1_by_cli, k2_by_cli = [], {}, {}, {}, {}

    def counts():
        return (dict(layered_spmv.LAUNCHES_BY_DTYPES),
                dict(plane_gs.LAUNCHES_BY_DTYPES))

    def cli(name, fn):
        os.chdir(dirs[name])
        before = counts()
        clock.take()
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        after = counts()
        k1_by_cli[name] = _launch_delta(before[0], after[0])
        k2_by_cli[name] = _launch_delta(before[1], after[1])
        splits[name] = clock.take()
        return out

    run_trace_save = sweep.run_trace_save

    def timed_run(Re, *args, **kwargs):
        clock.take()
        t0 = time.perf_counter()
        out = run_trace_save(Re, *args, **kwargs)
        runs.append(dict(Re=Re, out=out, wall=time.perf_counter() - t0,
                         split=clock.take()))
        return out

    stokes_res = []
    layered_spmv.reset_launches()
    plane_gs.reset_launches()
    streamtrace.reset_launches()
    try:
        for module in (inlet_batch, ns_channel):
            clock.wrap(module, "solve_ns_flow", "solve")
            clock.wrap(module, "save_navier_stokes_solution", "io_write")
        clock.wrap(stokes_channel, "solve_stokes_channel", "solve",
                   keep=stokes_res)
        clock.wrap(stokes_channel, "write_xdmf_function", "io_write")
        for module in (inlet_batch, streamtrace_cli):
            clock.wrap(module, "read_xdmf_function", "io_read")
            clock.wrap(module, "solve_inlet_profiles", "inlet")
            clock.wrap(module, "for_and_rev_streamtrace", "trace")
            clock.wrap(module, "save_trace_figures", "figures")
        sweep.run_trace_save = timed_run
        try:
            cli("sweep", lambda: sweep.main(
                ["re", img, f"{RE:g}", f"{RE_WARM:g}"]))
        finally:
            sweep.run_trace_save = run_trace_save
        (sol10, _, folder10), (sol20, _, folder20) = (
            r["out"] for r in runs)
        folder10 = os.path.join(dirs["sweep"], folder10)
        folder20 = os.path.join(dirs["sweep"], folder20)
        img_copy = shutil.copy(img, os.path.join(dirs["cli"], "circle.png"))
        res_cli = cli("cli", lambda: streamtrace_cli.main(
            [img_copy, os.path.join(folder10, "Re10ChannelVelocity"),
             "Velocity"]))
        sol_ns, folder_ns = cli("ns_channel", lambda: ns_channel.main(
            [f"{RE:g}", img, f"{RATIO:g}", f"{LC:g}"]))
        folder_ns = os.path.join(dirs["ns_channel"], folder_ns)
        mesh_s, _, u_s, p_s = cli("stokes_channel",
                                  lambda: stokes_channel.main(
                                      [img, f"{RATIO:g}", "0.1"]))
        outlet = os.path.join(ROOT, "build", "chip_smoke", "outlet.png")
        cmp_png = cli("compare", lambda: compare_images.main(
            [outlet, outlet, os.path.join(dirs["compare"], "compare.png")]))
    finally:
        clock.restore()
        os.chdir(cwd)
    k1, k2 = counts()
    k3 = streamtrace.LAUNCHES

    print(f"phase 17 on {card}", flush=True)
    # the sweep: Re=10 cold through the apps' route, Re=20 warm from it
    for r, folder in zip(runs, (folder10, folder20)):
        sol, res, _ = r["out"]
        re_i = int(r["Re"])
        vel = os.path.join(folder, f"Re{re_i}ChannelVelocity")
        prs = os.path.join(folder, f"Re{re_i}ChannelPressure")
        read_s, mb_u = _check_round_trip(np, vel, "Velocity", sol.mesh,
                                         sol.u, f"sweep Re={re_i}")
        _, mb_p = _check_round_trip(np, prs, "Pressure", sol.mesh, sol.p,
                                    f"sweep Re={re_i}")
        print(f"sweep Re={re_i}: run_trace_save {r['wall']:.3f} s wall, "
              f"split {_split(r['split'], r['wall'])}; io_write_s "
              f"{r['split']['io_write']:.4f}, io_read_s "
              f"{r['split']['io_read']:.4f} (a second read "
              f"{read_s:.4f}); Re{re_i}ChannelVelocity.h5 {mb_u:.3f} MB, "
              f"Re{re_i}ChannelPressure.h5 {mb_p:.3f} MB; outlet points "
              f"{len(res.outlet_points)}; Newton steps {sol.newton_iters}, "
              f"converged {sol.converged} ({card})", flush=True)
        _bar(bool(sol.converged) and np.isfinite(sol.w).all(),
             f"sweep Re={re_i} converged")
        svgs = ["inner_contour.svg", "inner_mesh.svg",
                f"rev_trace_circle_{NUM_SEEDS}.svg"]
        files = [f"Re{re_i}Channel{n}.{x}" for n in ("Velocity", "Pressure")
                 for x in ("xdmf", "h5")] + [
            "RunParameters.txt", "final_output.csv", "rev_seeds.csv"] + svgs
        missing = [f for f in files
                   if not os.path.exists(os.path.join(folder, f))]
        _bar(not missing, f"sweep Re={re_i}: every output file written "
                          f"(missing {missing})")
        _parse_svgs(folder, svgs, f"sweep Re={re_i}")
    _bar("coarse_ns" not in sol20.timings,
         "sweep Re=20 took the warm path (no coarse_ns)")

    u_ref, _ = sol10.space.split(w_ref)
    rel = _rel(np, sol10.u, u_ref)
    print(f"sweep Re=10 velocity vs channel_ns_prod.npz: rel-L2 {rel:.3e} "
          f"(bar 1e-6)", flush=True)
    _bar(rel < 1e-6, "sweep Re=10 velocity within rel-L2 1e-6 of "
                     "channel_ns_prod.npz")
    seeds = np.loadtxt(os.path.join(folder10, "rev_seeds.csv"),
                       delimiter=",")
    outlet_rows = np.loadtxt(os.path.join(folder10, "final_output.csv"),
                             delimiter=",", ndmin=2)
    same_shape = seeds.shape == fx["seeds"].shape
    d_seeds = float(np.abs(seeds - fx["seeds"]).max()) if same_shape \
        else np.inf
    n_out, n_ref = len(outlet_rows), len(fx["outlet_points"])
    print(f"sweep Re=10 rev_seeds.csv vs trace_prod.npz seeds: shape "
          f"{seeds.shape}, max abs {d_seeds:.3e}, bitwise "
          f"{same_shape and np.array_equal(seeds, fx['seeds'])}; "
          f"final_output.csv {n_out} outlet points (fixture {n_ref})",
          flush=True)
    _bar(same_shape and d_seeds <= 1e-6,
         "rev_seeds.csv equals trace_prod.npz's seeds (atol 1e-6, the "
         "trace's tolerance)")
    _bar(abs(n_out - n_ref) <= 2e-3 * n_ref,
         "final_output.csv outlet points within 0.2% of trace_prod.npz")
    rel = _rel(np, sol20.u, sol20_phase6.u)
    print(f"sweep Re=20 (warm) vs phase 6's warm Re=20: rel-L2 {rel:.3e} "
          f"(bar 1e-6)", flush=True)
    _bar(rel < 1e-6, "sweep Re=20 within rel-L2 1e-6 of phase 6's")

    # streamtrace_cli on the Re=10 checkpoint against the in-memory field
    inlet1, _ = solve_inlet_profiles(img, RATIO, DEFAULT)
    ref = for_and_rev_streamtrace(APPS_SEEDS_CLI, img, sol10.mesh, sol10.u,
                                  inlet1.mesh.points, DEFAULT, device=device)
    worst = {}
    for name, want in (("rev_seeds.csv", ref.seeds),
                       ("final_output.csv", ref.outlet_points)):
        got = np.loadtxt(os.path.join(dirs["cli"], name), delimiter=",",
                         ndmin=2)
        worst[name] = (float(np.abs(got - want).max())
                       if got.shape == want.shape and len(got) else np.inf)
        print(f"streamtrace_cli {name}: {got.shape} vs in-memory "
              f"{want.shape}, max abs {worst[name]:.3e} (atol 1e-6)",
              flush=True)
    _parse_svgs(dirs["cli"], ["inner_contour.svg", "inner_mesh.svg",
                              f"rev_trace_circle_{APPS_SEEDS_CLI}.svg"],
                "streamtrace_cli")
    _bar(len(res_cli.seeds) == APPS_SEEDS_CLI ** 2
         and max(worst.values()) <= 1e-6,
         "streamtrace_cli's CSVs: the in-memory trace's shapes, within "
         "atol 1e-6")

    # ns_channel and stokes_channel: the XDMF pairs read back bitwise
    read_ns = [_check_round_trip(
        np, os.path.join(folder_ns, f"Re10Channel{n}"), n, sol_ns.mesh, v,
        "ns_channel") for n, v in (("Velocity", sol_ns.u),
                                   ("Pressure", sol_ns.p))]
    rel = _rel(np, sol_ns.w, w_ref) if sol_ns.w.shape == w_ref.shape \
        else np.inf
    print(f"ns_channel: converged {sol_ns.converged}, Newton steps "
          f"{sol_ns.newton_iters}, rel-L2 vs channel_ns_prod.npz {rel:.3e} "
          f"(coarse_Re=1 route; for information); .h5 "
          f"{read_ns[0][1]:.3f} + {read_ns[1][1]:.3f} MB", flush=True)
    _bar(bool(sol_ns.converged) and np.isfinite(sol_ns.w).all(),
         "ns_channel converged")
    ((_, _, _, _, res_s),) = stokes_res
    read_st = [_check_round_trip(
        np, os.path.join(dirs["stokes_channel"], f"StokesChannel{n}"), n,
        mesh_s, v, "stokes_channel") for n, v in (("Velocity", u_s),
                                                  ("Pressure", p_s))]
    channel_fx = np.load(BCSR_FIXTURES[2])
    rel = _rel(np, res_s.x.cpu().numpy(), channel_fx["w"])
    print(f"stokes_channel: converged {res_s.converged}, FGMRES its "
          f"{res_s.iters}, rel-L2 vs stokes_channel.npz {rel:.3e} (bar "
          f"1e-6); .h5 {read_st[0][1]:.3f} + {read_st[1][1]:.3f} MB",
          flush=True)
    _bar(bool(res_s.converged) and rel < 1e-6,
         "stokes_channel converged, within rel-L2 1e-6 of "
         "stokes_channel.npz")

    # compare_images: an outlet image against itself
    sim = np.asarray(Image.open(outlet).convert("RGB"))
    crops = [compare_images.autocrop(sim), compare_images.autocrop(
        compare_images.remove_gray_background(sim))]
    size = (max(c.shape[1] for c in crops), max(c.shape[0] for c in crops))
    diff = np.asarray(Image.open(cmp_png).convert("RGB").crop(
        compare_images.panel_boxes(size)[2]))
    _bar(os.path.exists(cmp_png) and diff.size > 0 and not diff.any(),
         "compare_images wrote its PNG; the difference panel is all zero")

    splits["sweep"] = {k: sum(r["split"].get(k, 0.0) for r in runs)
                       for k in runs[0]["split"]}
    for name, wall in walls.items():
        print(f"{name}: {wall:.3f} s wall, split "
              f"{_split(splits[name], wall)}, K1 launches "
              f"{_by_pair(k1_by_cli[name])}, K2 launches "
              f"{_by_pair(k2_by_cli[name])} ({card})", flush=True)
    print(f"apps path: K1 launches {layered_spmv.LAUNCHES} {_by_pair(k1)}; "
          f"K2 launches {plane_gs.LAUNCHES} {_by_pair(k2)} ({card})",
          flush=True)
    _bar(layered_spmv.LAUNCHES > 0 and plane_gs.LAUNCHES > 0,
         "the apps path launched K1 and K2")
    # the sweep's two run_trace_save traces and streamtrace_cli's: one
    # launch a direction each
    _bar(k3 == 6, f"the apps path's three traces launched K3 6 times "
                  f"({k3})")
    loaded = [m for m in ("h5py", "matplotlib") if m in sys.modules]
    _bar(not loaded, f"neither h5py nor matplotlib imported ({loaded})")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s ({card})",
          flush=True)
    return k1, k2, k3


def run_clis(torch, cli, card):
    """Phase 18: the last validation CLIs and the examples as a user types
    them (phases 8 and 9 ran lid_driven and dfg2d), each held to the JAX
    package's results at the same argv."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import plane_gs

    t_phase = time.perf_counter()
    print(f"phase 18 on {card}", flush=True)
    # the subprocesses take the card's memory from this process's cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lines = cli.command(
        "dfg3d", [sys.executable, "-m", f"{PKG}.apps.dfg3d"],
        f"python3 -m {PKG}.apps.dfg3d", timeout=900)
    cd = cli.rule.values("dfg3d", lines)["cd"]
    _bar(abs(cd - DFG3D_CD) / DFG3D_CD < 0.02,
         f"dfg3d: Cd {cd:.6f} within 2% of {DFG3D_CD}")

    layered_spmv.reset_launches()
    plane_gs.reset_launches()
    cli.in_process("duct_stokes")
    cli.in_process("duct_stokes_th")
    print(f"duct_stokes and duct_stokes_th launched K1 "
          f"{layered_spmv.LAUNCHES} and K2 {plane_gs.LAUNCHES} times (the "
          f"block-CSR and Schur routes carry no hand-written kernel)",
          flush=True)

    # the README's command, from the repository root
    env = dict(os.environ, PYTHONPATH=".")
    for name in cli.rule.EXAMPLES:
        script = f"examples/torch_{name}.py"
        out = os.path.join(CLI_ROOT, name, "u.npy")
        cli.command(name, [sys.executable, script, out],
                    f"PYTHONPATH=. python3 {script} {out}", timeout=300,
                    env=env, field=out)

    print(f"phase 18 walls (s): "
          f"{json.dumps({n: round(cli.walls[n], 3) for n in cli.rule.CASES})}"
          f" ({card})", flush=True)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s ({card})",
          flush=True)


BENCH_REFS = os.path.join(FIXTURES, "bench_refs.npz")
BENCH_RULE = os.path.join(ROOT, "tests", "torch_bench_refs.py")
BENCH_RE40 = 40.0
BENCH_WORK = os.path.join(ROOT, "build", "chip_smoke", "bench")


def _bench_rule():
    """tests/torch_bench_refs.py (numpy only at import) and its fixture."""
    tests = os.path.dirname(BENCH_RULE)
    if tests not in sys.path:
        sys.path.append(tests)
    import torch_bench_refs

    return torch_bench_refs, torch_bench_refs.load(BENCH_REFS)


def _newton_its(sol) -> int:
    """Newton steps of a continuation solve, over its Newton calls (the
    one-mesh solve's steps are its "coarse" call's; the fine call starts
    converged)."""
    return sum(len(h) for k, h in sol.newton_history.items()
               if k != "refine")


def _hold_solution(np, rule, ref, sol, what, newton_its, idx) -> None:
    """The bench solve ``sol`` against the JAX package's (``ref``, one
    part of bench_refs.npz): the Newton steps within ``NEWTON_SLACK``, w
    at the sampled dofs ``idx`` within rel-L2 ``FIELD_REL``, the u and p
    norms within relative ``NORM_REL``."""
    _bar(abs(newton_its - ref["newton_its"]) <= rule.NEWTON_SLACK,
         f"{what}: Newton steps {newton_its} within {rule.NEWTON_SLACK} of "
         f"JAX's {ref['newton_its']}")
    rel = _rel(np, sol.w[idx], ref["w"])
    print(f"{what} vs JAX at {len(idx)} sampled dofs: rel-L2 {rel:.3e} "
          f"(bar {rule.FIELD_REL:g})", flush=True)
    _bar(rel < rule.FIELD_REL, f"{what} within rel-L2 {rule.FIELD_REL:g} "
                               f"of JAX's")
    for key, got in (("u_norm", np.linalg.norm(sol.u)),
                     ("p_norm", np.linalg.norm(sol.p))):
        r = abs(got - ref[key]) / ref[key]
        _bar(r <= rule.NORM_REL, f"{what} {key} {got:.12e} within relative "
                                 f"{rule.NORM_REL:g} of JAX's "
                                 f"{ref[key]:.12e} ({r:.2e})")


def run_bench_problem(torch, np, img, card, device):
    """Phase 19: the main path at bench.py's problem (lc=0.024, 1,053,696
    dofs), held to the JAX package's float64 results
    (tests/fixtures/bench_refs.npz).  Returns (K1 checks by pair, K2
    checks by pair, K1 launches and K2 launches of the Re=10 and Re=40
    solves by pair)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv, soa_element)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        matrix_values_layered, residual_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        solve_ns_flow)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes import (
        make_stokes_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.io.xdmf import (
        read_xdmf_function, write_xdmf_function)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import plane_gs
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (
        solve_newton_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace.pipeline import (
        for_and_rev_streamtrace)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (
        counts, spans)

    rule, refs = _bench_rule()
    lc, r5 = rule.LC, rule.ROUND5
    walls = {}
    t_phase = time.perf_counter()
    print(f"phase 19: bench.py's problem, lc={lc:g}, on {card}", flush=True)

    # (a) the host set-up, as bench.py::build_problem builds it
    t0 = time.perf_counter()
    mesh, st, inlet1 = rule.port_problem(img, device)
    torch.cuda.synchronize()
    walls["setup"] = time.perf_counter() - t0
    lp, a = st.lp, st.lp.arrays
    shape = rule.port_shape(mesh, st)
    print(f"bench set-up: {walls['setup']:.2f} s host ({card}); cells "
          f"{shape['n_cells']}, dofs {shape['ndofs']}, (n2d, Lp, E) "
          f"{(lp.n2d, lp.n_planes, lp.E)}, V-cycle levels "
          f"{shape['dims'].tolist()}", flush=True)
    for what, ok, detail in rule.check_shape(shape, rule.part(refs, "shape")):
        print(f"  bench_refs.npz: {detail}", flush=True)
        _bar(ok, f"bench problem: {what}")

    # (b) one Jacobian and one residual, then K1 on every level and pair,
    # K2 on levels 0-2 at J(0)
    t0 = time.perf_counter()
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / RE)
    jac_ms = time_ms(lambda: matrix_values_layered(
        kern, lp.E, lp.n_planes, lp.bs, a, st.g), 5)
    res_ms = time_ms(lambda: residual_layered(
        kern, lp.n2d, lp.n_planes, lp.bs, a, st.g), 5)
    print(f"bench assembly at g: Jacobian {jac_ms:.2f} ms, residual "
          f"{res_ms:.2f} ms (CUDA events, median of 5; one K4 launch and "
          f"the reduction each) ({card})", flush=True)
    k4 = k4_row(torch, np, kern, a.sasm, lp.n_planes, st.g,
                f"bench lc={lc:g}")
    levels = rule.port_levels(st, kern, st.g)
    print(f"K1 shapes at lc={lc:g} (J(g), Re=10): (E, Lp, n2d) per level "
          f"{[(op.values.shape[3], op.n_planes, op.n2d) for op in levels]}",
          flush=True)
    every = {p[:2]: range(len(levels)) for p in PAIRS}
    k1 = {c["pair"]: c for c in check_levels(torch, np, levels, PAIRS,
                                              device, on_levels=every)}
    del levels
    stokes_k = make_stokes_kernel(
        "tetrahedron", nu=1.0, mu_T_coeff=DEFAULT.stab.stokes_mu_T_coeff)
    levels = rule.port_levels(st, stokes_k, torch.zeros_like(st.mask))
    k2 = {p[:2]: dict(errs=[]) for p in K2_PAIRS}
    flush = L2Flush(torch, device)
    check_k2_levels(torch, np, levels, f"Stokes J(0) lc={lc:g}",
                    np.random.default_rng(3), flush, k2)
    del levels, flush
    for (vname, aname), c in k2.items():
        print(f"K2 ({vname}, {aname}) level-0 plan at lc={lc:g}: "
              f"{json.dumps(c['plan'])}", flush=True)
    _bar(k2[("float64", "float64")]["plan"]["slots"] == 0,
         "K2 (float64, float64) reads level 0's values from device memory "
         "(no value ring fits)")
    walls["kernel_checks"] = time.perf_counter() - t0

    # (c) the headline: five max_it=1 Newton steps from g
    h, hl = rule.HEADLINE, rule.part(refs, "headline")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, its, step_s, f_ratio = st.g, [], [], []
    for _ in range(h["steps"]):
        t1 = time.perf_counter()
        out = solve_newton_layered(
            kern, lp.n2d, lp.n_planes, lp.bs, a, st.mask, st.g, w, lp.E,
            0.0, 0.0, 1, h["ksp_rtol"], h["ksp_restart"],
            h["ksp_max_restarts"], h["pc"], st.mg)
        w = out.x
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        its.append(int(out.history[0, 2]))
        f_ratio.append(float(out.history[0, 0])
                       / float(hl["fnorm"][len(its) - 1]))
        print(f"headline step {len(its)}: FGMRES its {its[-1]}, lambda "
              f"{float(out.history[0, 1]):g}, |F| {float(out.history[0, 0]):.6e}"
              f" (JAX f64 on the CPU: {int(hl['its'][len(its) - 1])}, "
              f"{float(hl['fnorm'][len(its) - 1]):.6e}; |F| / JAX's "
              f"{f_ratio[-1]:.4f}); {step_s[-1]:.3f} s ({card})", flush=True)
    walls["headline"] = time.perf_counter() - t0
    print(f"headline FGMRES its {its}, JAX f64 {hl['its'].tolist()}, round 5 "
          f"{list(r5['fgmres_its'])}; |F| / JAX's "
          f"{[round(r, 4) for r in f_ratio]}; steps (s) "
          f"{[round(t, 3) for t in step_s]}", flush=True)
    _bar(len(its) == len(hl["its"]) and all(
        abs(i - int(j)) <= rule.HEADLINE_KSP_SLACK
        for i, j in zip(its, hl["its"])),
        f"headline: {len(its)} Newton steps, each step's FGMRES its within "
        f"{rule.HEADLINE_KSP_SLACK} of JAX's")
    del st, w, out, a, lp

    # (d) the converged Re=10 solve on the user's path
    cv = rule.part(refs, "converged")
    layered_spmv.reset_launches()
    plane_gs.reset_launches()
    k4_before = counts(soa_element.COUNTER)
    sid0 = max((sp[0] for sp in spans()), default=-1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol10 = solve_ns_flow(RE, img, RATIO, channel_mesh_size=lc, coarse_lc=lc,
                          device=device)
    torch.cuda.synchronize()
    walls["re10"] = time.perf_counter() - t0
    k1_10 = dict(layered_spmv.LAUNCHES_BY_DTYPES)
    k2_10 = dict(plane_gs.LAUNCHES_BY_DTYPES)
    peak10 = torch.cuda.max_memory_allocated()
    _print_solution(sol10, f"bench Re=10 ({card})", walls["re10"])
    n10 = _newton_its(sol10)
    print(f"bench Re=10: Stokes FGMRES its {sol10.stokes_iters} (JAX "
          f"{cv['stokes_its']}), Newton {n10} (JAX {cv['newton_its']}, round "
          f"5 {r5['converged_newton_its']} + {r5['refine_its']} refine), |F| "
          f"{sol10.newton_resnorm:.3e} (JAX {cv['fnorm']:.3e}); K1 launches "
          f"{_by_pair(k1_10)}, K2 launches {_by_pair(k2_10)}; peak "
          f"{peak10 / 2 ** 30:.2f} GiB allocated", flush=True)
    _bar(sol10.converged and np.isfinite(sol10.w).all(),
         "bench Re=10 converged")
    _hold_solution(np, rule, cv, sol10, "bench Re=10", n10, cv["idx"])

    # (e) Re=40 by the sweep's warm route, from (d)
    layered_spmv.reset_launches()
    plane_gs.reset_launches()
    t0 = time.perf_counter()
    sol40 = solve_ns_flow(BENCH_RE40, img, RATIO, channel_mesh_size=lc,
                          coarse_lc=lc, device=device, warm=sol10)
    torch.cuda.synchronize()
    walls["re40"] = time.perf_counter() - t0
    k1_40 = dict(layered_spmv.LAUNCHES_BY_DTYPES)
    k2_40 = dict(plane_gs.LAUNCHES_BY_DTYPES)
    _print_solution(sol40, f"bench Re=40 warm ({card})", walls["re40"])
    print(f"bench Re=40: Newton {sol40.newton_iters} (JAX "
          f"{refs['re40__newton_its']}; round 5: {r5['re40_newton_its']} f32 "
          f"+ {r5['re40_refine_its']} refine, another route), |F| "
          f"{sol40.newton_resnorm:.3e} (JAX {refs['re40__fnorm']:.3e}); K1 "
          f"launches {_by_pair(k1_40)}, K2 launches {_by_pair(k2_40)}; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    _bar(sol40.converged and np.isfinite(sol40.w).all(),
         "bench Re=40 converged (SNES rtol = atol = 1e-8)")
    _bar(not any(k.startswith("coarse") for k in sol40.newton_history),
         "bench Re=40 took the warm route (no coarse phase)")
    _hold_solution(np, rule, rule.part(refs, "re40"), sol40, "bench Re=40",
                   sol40.newton_iters, cv["idx"])
    k4_launches = {}
    for key, n in counts(soa_element.COUNTER, k4_before).items():
        k4_launches[key[-1]] = k4_launches.get(key[-1], 0) + n
    evals = {e: sum(1 for sp in spans() if sp[0] > sid0 and sp[3] == e)
             for e in K4_ENTRIES}
    print(f"bench Re=10 and Re=40: K4 launches {k4_launches}, the "
          f"program's jacobian and residual spans {evals}", flush=True)
    _bar(k4_launches == evals, "bench Re=10 and Re=40: one K4 launch a "
         "Jacobian and a residual evaluation")
    k1_launches = {k: k1_10.get(k, 0) + k1_40.get(k, 0)
                   for k in set(k1_10) | set(k1_40)}
    k2_launches = {k: k2_10.get(k, 0) + k2_40.get(k, 0)
                   for k in set(k2_10) | set(k2_40)}
    del sol10

    # (f) checkpoint and trace, as bench.py::run_trace_io
    shutil.rmtree(BENCH_WORK, ignore_errors=True)
    os.makedirs(BENCH_WORK)
    base = os.path.join(BENCH_WORK, "Re40ChannelVelocity")
    t0 = time.perf_counter()
    write_xdmf_function(base, sol40.mesh, sol40.u, "Velocity")
    write_xdmf_function(os.path.join(BENCH_WORK, "Re40ChannelPressure"),
                        sol40.mesh, sol40.p, "Pressure")
    io_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_r, u_r = read_xdmf_function(base, "Velocity")
    io_read_s = time.perf_counter() - t0
    want = np.asarray(sol40.u, np.float64)
    _bar(u_r.dtype == np.float64 and u_r.tobytes() == want.tobytes()
         and np.array_equal(mesh_r.cells, sol40.mesh.cells)
         and mesh_r.points.tobytes() == sol40.mesh.points.tobytes(),
         "bench: Re40ChannelVelocity.h5 read back equals the field and mesh "
         "bit for bit")
    print(f"bench I/O: io_write_s {io_write_s:.4f}, io_read_s "
          f"{io_read_s:.4f}, Re40ChannelVelocity.h5 {_mb(base + '.h5'):.2f} "
          f"MB ({card})", flush=True)
    seeds, tr = inlet1.mesh.points, rule.part(refs, "trace")
    trace = {}
    for warm in (False, True):
        t0 = time.perf_counter()
        res = for_and_rev_streamtrace(NUM_SEEDS, img, mesh_r, u_r, seeds,
                                      DEFAULT, device=device)
        wall = time.perf_counter() - t0
        stt = res.stats
        tag = "warm" if warm else "cold"
        trace[tag] = dict(
            trace_warm=warm, wall_s=wall, n_outlet_points=len(
                res.outlet_points),
            **{k: stt[k] for k in ("seeds", "seed_steps", "lane_steps",
                                   "dispatches", "locator_build_s", "fwd_s",
                                   "rev_s")})
        print(f"bench trace {json.dumps(trace[tag])} ({card})", flush=True)
        _bar(np.isfinite(res.forward_endpoints).all()
             and np.isfinite(res.reverse_endpoints).all(),
             f"bench trace ({tag}) endpoints finite")
        n_out, steps = len(res.outlet_points), stt["seed_steps"]
        print(f"bench trace ({tag}): outlet points {n_out} (JAX f64 "
              f"{tr['n_outlet_points']}, round 5 {r5['n_outlet_points']}), "
              f"kept forward {len(res.forward_endpoints)} (JAX f64 "
              f"{tr['n_forward_kept']}), seed_steps {steps} (JAX f64 "
              f"{tr['seed_steps']}, JAX f32 {tr['f32_seed_steps']}, round 5 "
              f"{r5['trace_seed_steps']}), "
              f"lane_steps {stt['lane_steps']} (JAX f64 {tr['lane_steps']},"
              f" round 5 {r5['trace_lane_steps']})", flush=True)
        for ref, who in ((tr["n_outlet_points"], "JAX f64's"),
                         (r5["n_outlet_points"], "round 5's")):
            _bar(abs(n_out - ref) <= rule.OUTLET_REL * ref,
                 f"bench trace ({tag}): outlet points {n_out} within "
                 f"{rule.OUTLET_REL:.1%} of {who} {ref}")
        _bar(abs(steps - tr["seed_steps"])
             <= rule.SEED_STEPS_REL * tr["seed_steps"],
             f"bench trace ({tag}): seed_steps {steps} within "
             f"{rule.SEED_STEPS_REL:.0%} of JAX f64's {tr['seed_steps']}")
        _bar(all(isinstance(stt[k], int) for k in ("seed_steps",
                                                    "lane_steps")),
             f"bench trace ({tag}): the step counters are Python ints "
             f"(64-bit and more)")
    walls["trace_cold"] = trace["cold"]["wall_s"]
    walls["trace_warm"] = trace["warm"]["wall_s"]
    walls["io"] = io_write_s + io_read_s
    t0 = time.perf_counter()
    k3 = k3_row(torch, np, mesh_r, u_r, res.seeds, device,
                f"bench lc={lc:g} reverse grid")
    walls["k3_row"] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    print(f"phase 19 walls (s): "
          f"{json.dumps({k: round(v, 3) for k, v in walls.items()})} "
          f"({card})", flush=True)
    return k1, k2, k1_launches, k2_launches, k3, k4, k4_launches


def run_k4_pillar(torch, np, card, device) -> dict:
    """K4's row at the DFG 3D-1Z pillar of the benchmark's
    ``dfg3d-1z`` configuration (scale 0.25; the textbook SUPS flux) at
    its g."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import dfg3d
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)

    t0 = time.perf_counter()
    prob = dfg3d.setup_dfg3d(K4_PILLAR_SCALE, 1.0, 0.15, 3, device=device)
    print(f"K4 pillar set-up (scale {K4_PILLAR_SCALE}): "
          f"{time.perf_counter() - t0:.2f} s host, {prob.mesh.n_cells} "
          f"cells, Lp {prob.lp.n_planes} ({card})", flush=True)
    kern = make_ns_sups_kernel("tetrahedron", nu=dfg3d.NU,
                               transposed_stab=False)
    return k4_row(torch, np, kern, prob.lp.arrays.sasm, prob.lp.n_planes,
                  prob.g, f"DFG 3D-1Z pillar scale {K4_PILLAR_SCALE}")


def _dtypes(torch, pair) -> tuple:
    """("float64", "float32") -> (torch.float64, torch.float32)."""
    return tuple(getattr(torch, n) for n in pair)


def _by_pair(launches) -> dict:
    return {f"{str(v).removeprefix('torch.')} values, "
            f"{str(x).removeprefix('torch.')} x": n
            for (v, x), n in launches.items()}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        return fail(f"needs torch and numpy ({e})")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, PKG)) or not all(
            os.path.exists(f)
            for f in (FIXTURE, TRACE_FIXTURE, GRAFT_ENTRY, CLI_REFS,
                      CLI_RULE, BENCH_REFS, BENCH_RULE) + BCSR_FIXTURES):
        return fail(f"run from a checkout of the repository ({PKG}/, "
                    f"__graft_entry_torch__.py and tests/ beside this "
                    f"script)")
    sys.path.insert(0, ROOT)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        layered_spmv, soa_element)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import plane_gs
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (
        streamtrace)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import nvcc
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
        make_annulus_image)

    device = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {kind}",
          flush=True)

    # the kernels' nvcc runs at once, then each wrapper loads its library
    t0 = time.perf_counter()
    nvcc.build(*nvcc.KERNELS)
    layered_spmv.build()
    plane_gs.build()
    streamtrace.build()
    soa_element.build()
    print(f"K1, K2, K3 and K4 build: {time.perf_counter() - t0:.2f} s",
          flush=True)
    print("\n".join(line for log in nvcc.LOGS.values()
                    for line in log.splitlines() if "ptxas" in line),
          flush=True)

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    img = make_annulus_image(os.path.join(work, "circle.png"), "circle")

    try:
        cli = CliRuns()
        checks = check_levels(torch, np, k1_levels(torch, np, img, device),
                              PAIRS, device)
        launches, k2_main, sol, f64_wall = run_main_path(torch, np, img,
                                                         device)
        inlet1, k3 = run_trace(torch, np, img, sol, device)
        check_trace_arithmetic(torch, np, sol, inlet1, device)
        sol20 = run_warm_sweep(torch, np, img, sol, device)
        tfqmr_launches = run_tfqmr_main_path(torch, np, img, device)
        run_bcsr_cases(torch, np, img, device, cli)
        run_dfg2d(torch, np, cli)
        run_taylor_hood(torch, np, device)
        dfg3d_checks, dfg3d_launches = run_dfg3d(torch, np, device)
        run_apps_route(torch, np, img, device)
        run_reynolds_ladder(torch, np, img, device)
        slab_checks, sharded_launches = run_sharded(torch, np, img, device)
        k2_checks, k2_bf16 = run_plane_gs(torch, np, img, device)
        f32_launches, k2_f32 = run_f32_main_path(torch, np, img, device,
                                                 f64_wall)
        apps_launches, k2_apps, k3_apps = run_apps(torch, np, img, sol20,
                                                   card, device)
        run_clis(torch, cli, card)
        k1_bench, k2_bench, k1_bench_launches, k2_bench_launches, \
            k3_bench, k4_bench, k4_launches = run_bench_problem(
                torch, np, img, card, device)
        k4_pillar = run_k4_pillar(torch, np, card, device)
    except Exception as e:  # report the failing phase, exit nonzero
        import traceback

        traceback.print_exc()
        return fail(str(e))
    by_path = {"main": launches, "tfqmr": tfqmr_launches,
               "dfg3d": dfg3d_launches, "sharded": sharded_launches,
               "f32": f32_launches, "apps": apps_launches}
    k2_by_path = {"main": k2_main, "mg_bf16": k2_bf16, "f32": k2_f32,
                  "apps": k2_apps}
    on_pillar = {c["pair"]: c for c in dfg3d_checks}
    on_slab = {c["pair"]: c for c in slab_checks}

    def count(c, path):
        return by_path[path].get(_dtypes(torch, c["pair"]), 0)

    missing = [c["pair"] for c in checks if count(c, c["path"]) == 0]
    if missing:
        return fail(f"the solve of its path never launched K1 for {missing}")
    # the TFQMR path's V-cycles stream f64 values only
    missing = [c["pair"] for c in checks
               if c["pair"][0] == "float64" and count(c, "tfqmr") == 0]
    if missing:
        return fail(f"the TFQMR solve never launched K1 for {missing}")
    # phase 19's Re=10 and Re=40 solves run the main path's pairs
    missing = [c["pair"] for c in checks if c["path"] == "main"
               and k1_bench_launches.get(_dtypes(torch, c["pair"]), 0) == 0]
    if missing:
        return fail(f"the bench problem's solves never launched K1 for "
                    f"{missing}")
    if k2_bench_launches.get((torch.float64, torch.float64), 0) == 0:
        return fail("the bench problem's solves never launched K2 "
                    "(float64, float64)")
    if not all(k4_launches.get(e, 0) for e in K4_ENTRIES):
        return fail(f"the bench problem's solves never launched K4 for "
                    f"each entry: {k4_launches}")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [dict(
        name=f"layered_spmv[{c['pair'][0]} values, {c['pair'][1]} x]",
        route="cuda",
        source=f"{PKG}/csrc/layered_spmv.cu",
        replaces=TPU_KERNEL,
        launches=count(c, c["path"]), path=c["path"],
        launches_tfqmr=count(c, "tfqmr"),
        launches_f32=count(c, "f32"),
        launches_dfg3d=count(c, "dfg3d"),
        launches_sharded=count(c, "sharded"),
        launches_apps=count(c, "apps"),
        max_abs_err=max(c["max_abs_err"],
                        on_pillar.get(c["pair"], c)["max_abs_err"],
                        on_slab.get(c["pair"], c)["max_abs_err"]),
        ms=c["ms"], ms_b2b=c["ms_b2b"],
        ms_unmasked=c["ms_unmasked"], plain_ms=c["plain_ms"],
        bound_ms=c["bound_ms"], bound_by=c["bound_by"],
        library_ms=c["library_ms"], library=c["library"],
        ms_dfg3d=on_pillar[c["pair"]]["ms"] if c["pair"] in on_pillar
        else None,
        bound_ms_dfg3d=on_pillar[c["pair"]]["bound_ms"]
        if c["pair"] in on_pillar else None,
        ms_slab=on_slab[c["pair"]]["ms"] if c["pair"] in on_slab else None,
        bound_ms_slab=on_slab[c["pair"]]["bound_ms"]
        if c["pair"] in on_slab else None,
        ms_bench=k1_bench[c["pair"]]["ms"],
        bound_ms_bench=k1_bench[c["pair"]]["bound_ms"],
        plain_ms_bench=k1_bench[c["pair"]]["plain_ms"],
        library_ms_bench=k1_bench[c["pair"]]["library_ms"],
        launches_bench=k1_bench_launches.get(_dtypes(torch, c["pair"]), 0))
        for c in checks] + [dict(
        name=f"plane_gs[{vname} values, {aname} iterate]",
        route="cuda",
        source=f"{PKG}/csrc/plane_gs.cu",
        replaces=K2_REPLACES,
        launches=k2_by_path[path].get(
            (getattr(torch, vname), getattr(torch, aname)), 0),
        path=path,
        launches_apps=k2_apps.get(
            (getattr(torch, vname), getattr(torch, aname)), 0),
        max_abs_err=max(k2_checks[(vname, aname)]["errs"]),
        ms=k2_checks[(vname, aname)]["ms"],
        plain_ms=k2_checks[(vname, aname)]["plain_ms"],
        bound_ms=k2_checks[(vname, aname)]["bound_ms"],
        bound_by=k2_checks[(vname, aname)]["bound_by"],
        cluster=k2_checks[(vname, aname)]["cluster"],
        barrier_chain_ms=k2_checks[(vname, aname)]["chain_ms"],
        ms_bench=k2_bench[(vname, aname)]["ms"],
        bound_ms_bench=k2_bench[(vname, aname)]["bound_ms"],
        plain_ms_bench=k2_bench[(vname, aname)]["plain_ms"],
        plan_bench=k2_bench[(vname, aname)]["plan"],
        launches_bench=k2_bench_launches.get(
            _dtypes(torch, (vname, aname)), 0),
        library_ms=None,
        library="none: no single PyTorch call computes a plane Gauss-Seidel "
                "sweep")
        for vname, aname, _, path in K2_PAIRS] + [dict(
        name=f"streamtrace[{name}]", route="cuda",
        source=f"{PKG}/csrc/streamtrace.cu", replaces=K3_REPLACES,
        launches=k3["launches"] if name == "float64" else 0,
        path="main" if name == "float64" else "k3 row",
        launches_apps=k3_apps if name == "float64" else 0,
        lanes=k3["lanes"], ms=k3[name]["ms"],
        bound_ms=max(k3[name]["bound_bytes_ms"], k3[name]["bound_chain_ms"]),
        bound_by=("bytes" if k3[name]["bound_bytes_ms"]
                  >= k3[name]["bound_chain_ms"] else "latency"),
        bound_bytes_ms=k3[name]["bound_bytes_ms"],
        bound_chain_ms=k3[name]["bound_chain_ms"],
        longest_lane_steps=k3[name]["longest_lane_steps"],
        l2_latency_ns=k3["l2_latency_ns"], plain_ms=k3[name]["plain_ms"],
        ms_bench=k3_bench[name]["ms"],
        bound_bytes_ms_bench=k3_bench[name]["bound_bytes_ms"],
        bound_chain_ms_bench=k3_bench[name]["bound_chain_ms"],
        plain_ms_bench=k3_bench[name]["plain_ms"],
        ptxas=k3["ptxas"].get(name), library_ms=None,
        library="none: no PyTorch call integrates an ODE")
        for name in ("float64", "float32")] + [dict(
        name=f"soa_element[{entry}]", route="cuda",
        source=f"{PKG}/csrc/soa_element.cu", replaces=K4_REPLACES,
        launches=k4_launches.get(entry, 0), path="bench",
        max_rel_err=max(k4_bench[entry]["rel_err"],
                        k4_pillar[entry]["rel_err"]),
        ms_bench=k4_bench[entry]["ms"],
        bound_ms_bench=k4_bench[entry]["bound_ms"],
        bound_by_bench=k4_bench[entry]["bound_by"],
        plain_ms_bench=k4_bench[entry]["plain_ms"],
        ms_dfg3d=k4_pillar[entry]["ms"],
        bound_ms_dfg3d=k4_pillar[entry]["bound_ms"],
        bound_by_dfg3d=k4_pillar[entry]["bound_by"],
        plain_ms_dfg3d=k4_pillar[entry]["plain_ms"],
        ptxas=k4_bench["ptxas"], library_ms=None,
        library="none: no PyTorch call computes the SUPS/LSIC element form")
        for entry in K4_ENTRIES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
