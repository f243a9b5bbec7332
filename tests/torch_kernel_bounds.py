"""The yardsticks of the port's hand kernels K1-K4, outside the program:
their least times on the card, the timers that read them, and the K1
and K2 problems they are read on.

chip_smoke.py, profile_torch_k1.py, profile_torch_k2.py and the tests
import it (with ``tests/`` on their path); it imports no jax, and
nothing of the port or of torch at import, so the card's machine can
run it.

* Rates: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s
  float32, 34 TFLOP/s float64 outside the tensor cores.  The benchmark
  keeps its own copy in ``portbench/harness/kernels.py``.
* K1 and K2: ``k1_bound`` and ``k2_bound`` call that frozen copy with
  the operand's shape, so the smoke run's bound is the one
  ``k1_roofline_pct`` and ``k2_roofline_pct`` divide by.
* K3: ``k3_bounds``, the bytes of its tables over the memory rate and
  the longest lane's chain of dependent loads at the latency
  ``load_latency_ns`` reads.
* K4: ``k4_flops_per_cell`` and ``k4_bound``, counted from
  ``csrc/soa_element.cu``.
* Timers: ``time_ms`` (back to back, CUDA events), ``time_flushed_ms``
  (L2 cold, ``L2Flush``) and ``time_b2b_ms``.
* Problems: ``k1_levels`` and ``k2_problem``/``k2_levels``, the lc=0.04
  channel's V-cycle levels, and ``solve_levels``, the levels on which
  each K1 type pair runs in chip_smoke.py's solves.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import kernels as frozen  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {8: 34e12, 4: 67e12}   # by the element size of the iterate
FLUSH_BYTES = 256 * 2 ** 20  # written between flushed launches (> 50 MB L2)
CHASE_LOADS = 100_000       # dependent loads a latency reading follows
# the lc=0.04 channel, which chip_smoke.py's phase 3 solves and on whose
# V-cycle levels K1 and K2 are read
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "channel_ns_prod.npz")
RE, RATIO, LC = 10.0, 0.5, 0.04

# Operations a cell costs K4 (a fused multiply-add counts 2), counted from
# csrc/soa_element.cu, by flux (soa_element.FLUX_NAMES): the cell's set-up
# (geometry, basis gradients, the metric or the diameter, Gu and gp), then
# per quadrature point the values (32), the flux (primal, or in dual
# numbers along one tangent) and the E^T contraction into 16 accumulators
# (144), and the 16 scalings (32).  The Jacobian's 16 threads a cell each
# do all of it.
K4_SETUP_FLOPS = {"sups_t": 275, "sups": 275, "ugn": 279}
K4_FLUX_FLOPS = {"sups_t": (112, 322), "sups": (97, 274),
                 "ugn": (88, 241)}   # (primal, dual)
K4_NQ = 4                            # quadrature points of the source's rule


def _size(dtype) -> int:
    import torch

    return torch.tensor([], dtype=dtype).element_size()


def k1_bound(op, vdtype, xdtype, masked: bool):
    """(bound_ms, "bytes" | "operations") of one K1 call on the V-cycle
    level ``op`` (solve/mg.py::LevelOperator, canonical (4, 4, 3, E, Lp)
    values) in the type pair (``vdtype`` values, ``xdtype`` x):
    ``portbench/harness/kernels.py::k1_bound`` at its shape."""
    return frozen.k1_bound(op.values.shape[3], op.n_planes, op.n2d,
                           _size(vdtype), _size(xdtype), masked)


def k2_bound(op):
    """(bound_ms, "bytes" | "operations") of one K2 call on the prepared
    operand ``op`` (solve/plane_gs.py::PlaneGSOperand):
    ``portbench/harness/kernels.py::k2_bound`` at its shape."""
    return frozen.k2_bound(op.E, op.Lp, op.n2d, op.values.element_size(),
                           op.mask.element_size(), op.inner_sweeps,
                           op.symmetric)


def k3_bounds(dloc, u_cell, x0, longest: int, l2_ns: float):
    """(table bytes, bytes bound ms, chain bound ms) of one K3 launch on
    the seeds ``x0``: the locator's tables, the packed field and the seeds
    read and the endpoints written once, plus 9 bytes a lane (steps and
    done), over the memory rate; and the longest lane's ``longest`` steps
    of 6 stages of 4 dependent loads at ``l2_ns`` each."""
    tables = (dloc.x_planes, dloc.tab2, dloc.prism_base, dloc.prism_geom,
              u_cell)
    nbytes = (sum(t.numel() * t.element_size() for t in tables)
              + 2 * x0.numel() * x0.element_size() + 9 * len(x0))
    return (nbytes, nbytes / HBM_BYTES_PER_S * 1e3,
            longest * 6 * 4 * l2_ns * 1e-6)


def k4_flops_per_cell(flux: str, entry: str) -> int:
    """Operations K4 spends on one live cell (``K4_FLUX_FLOPS``)."""
    primal, dual = K4_FLUX_FLOPS[flux]
    per_thread = K4_SETUP_FLOPS[flux] + K4_NQ * (
        32 + (dual if entry == "jacobian" else primal) + 144) + 32
    return per_thread * (16 if entry == "jacobian" else 1)


def k4_bound(entry: str, flux: str, sasm, Lp: int, w,
             live_cells: int) -> dict:
    """The least time the card could take for one K4 launch: the bytes
    (the output written once, coordinates, alive, the gather tables and w
    read once) over the memory rate, and the operations of the live cells
    over the card's vector rate in w's dtype."""
    M3p = sasm.wdof.shape[0]
    nl = Lp - 1
    item = w.element_size()
    out_rows = M3p * 256 if entry == "jacobian" else M3p * 16 + 1
    nbytes = (out_rows * nl * item + 12 * M3p * nl * item + 4 * M3p * nl
              + 2 * 16 * 8 * M3p + w.numel() * item)
    flops = k4_flops_per_cell(flux, entry) * live_cells
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / FLOPS_PER_S[item] * 1e3
    return dict(bytes=nbytes, flops=flops, bytes_ms=b_ms, flops_ms=f_ms,
                ms=max(b_ms, f_ms),
                bound_by="bytes" if b_ms >= f_ms else "operations")


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
