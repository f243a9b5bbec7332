"""The JAX package's float64 results at bench.py's problem (the circle
image, flow-rate ratio 0.5, lc=0.024: 1,453,698 cells, 1,053,696 dofs),
and the rules that hold the port's runs to them.

    JAX_PLATFORMS=cpu python tests/torch_bench_refs.py [part ...]

runs ``generate()`` on the CPU in float64 and writes
tests/fixtures/bench_refs.npz (``np.savez_compressed``; the parts not
named are kept from the file).  The parts, each written as it finishes:

* ``shape``: the problem as ``bench.py::build_problem`` builds it
  (``generate_channel_mesh(img, 0.024, DEFAULT, layered=True)`` and
  ``_setup_layered(..., mg_levels=3)``): cells, ndofs, n2d, Lp, E, the
  V-cycle levels' (n2d, Lp, E), and checksums of the layered pattern and
  of the BC mask and values (``problem_shape``);
* ``headline``: five ``max_it=1`` Newton steps of
  ``solve/driver.py::solve_newton_layered`` from ``g`` at Re=10, with
  ``bench.py::aot_newton_step``'s arguments (``HEADLINE``): each step's
  FGMRES iterations, line-search lambda and |F|;
* ``converged``: ``solve_ns_flow(10, img, 0.5, 0.024, coarse_lc=0.024)``
  with the defaults (the Stokes start, then Newton on the one mesh): the
  Stokes iterations, the Newton steps and final |F|, the 2-norms of u
  and p, and w at ``N_SAMPLE`` dofs drawn by ``sample_indices``;
* ``re40``: Re=40 by the sweep's warm route from that solution
  (``solve_ns_flow(40, ..., warm=<Re=10>)``): the Newton steps, |F|,
  the norms and the sampled w as above; then the reference's trace of
  its velocity (``trace/pipeline.py::for_and_rev_streamtrace(200, ...)``,
  as ``bench.py::run_trace_io`` runs it): the outlet points, the kept
  forward endpoints, ``seed_steps`` and ``lane_steps``; the same counts
  (``trace__f32_*``) of the same field traced again with x64 off, in
  float32 as round 5 traced it.  It reruns the converged part first.

All parts take about 37 minutes on an 8-core CPU and ~9.5 GB of
memory: the headline 8, the converged solve 8-10, Re=40 9, each trace
0.3.  The round-5 record traced in float32 on the TPU and counted
931,396 seed steps; this f64 trace counts 883,253 and the float32 one
930,011, with round 5's 21,734 outlet points and 5,693,440 lane steps
to the unit.  In f64 the two packages agree to a few steps (960,285
against 960,280 at lc=0.04, tests/fixtures/trace_prod.npz), and the
port traces in f64, so ``seed_steps`` is held to the f64 trace and the
float32 and round-5 counts are printed beside it.  This module imports jax only inside
``generate()``, and nothing of either package at import:
chip_smoke.py imports it on a machine without jax.
"""

from __future__ import annotations

import hashlib
import pathlib
import sys
import tempfile
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FIXTURE = HERE / "fixtures" / "bench_refs.npz"

LC = 0.024              # bench.py:932
RATIO = 0.5
RE = 10.0
MG_LEVELS = 3
# bench.py::aot_newton_step: max_it=1 steps from g, rtol = atol = 0
HEADLINE = dict(steps=5, ksp_rtol=1e-3, ksp_restart=50, ksp_max_restarts=4,
                pc="mg_cheby6_bf16")
N_SAMPLE = 8192
PARTS = ("shape", "headline", "converged", "re40")

# benchmarks/records/bench_1m_2026-08-21_round5.json: the JAX package's
# run of this problem (float32 with a double-float refine), counts only
ROUND5 = dict(fgmres_its=(10, 20, 23, 21, 11), converged_newton_its=3,
              refine_its=2, re40_newton_its=6, re40_refine_its=2,
              n_outlet_points=21734, trace_seed_steps=931396,
              trace_lane_steps=5693440)

# bars of the port's runs against the fixture
G_REL = 1e-12           # the BC values' norm and projection
HEADLINE_KSP_SLACK = 2  # the card's bf16 V-cycle rounds differently
NEWTON_SLACK = 1        # the converged solve's Newton steps
FIELD_REL = 1e-6        # w at the sampled dofs, relative L2
NORM_REL = 1e-6         # |u|, |p|
OUTLET_REL = 2e-3       # the trace's outlet points
SEED_STEPS_REL = 1e-2   # the trace's seed steps


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def problem_shape(n_cells, ndofs, n2d, n_planes, E, dims, rows2d, cols2d,
                  mask, g) -> dict:
    """The counts and checksums that identify the problem: the pattern
    (``rows2d``, ``cols2d`` as int64) and the mask (as uint8) by sha256,
    the BC values ``g`` (float64) by norm and by their projection on a
    seeded normal vector (compared at relative ``G_REL``: the inlet
    profiles are solved, so the last bits may differ)."""
    mask = np.asarray(mask, np.float64)
    g = np.asarray(g, np.float64)
    proj = np.random.default_rng(1).standard_normal(len(g))
    return dict(
        n_cells=int(n_cells), ndofs=int(ndofs), n2d=int(n2d),
        n_planes=int(n_planes), E=int(E),
        dims=np.asarray(dims, np.int64).reshape(-1, 3),
        pattern_sha=_digest(np.stack([np.asarray(rows2d, np.int64),
                                      np.asarray(cols2d, np.int64)])),
        mask_sha=_digest((mask > 0.5).astype(np.uint8)),
        n_fixed=int((mask < 0.5).sum()),
        g_norm=float(np.linalg.norm(g)), g_proj=float(proj @ g))


def port_problem(img, device):
    """``bench.py::build_problem`` through the port, on ``device``:
    (mesh, ``flow/channel.py::LayeredSetup`` in float64, inlet1)."""
    import torch

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (
        DEFAULT)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        _setup_layered, generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)

    inlet1, inlet2 = solve_inlet_profiles(img, RATIO, DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, LC, DEFAULT)
    st = _setup_layered(mesh, inlet1, inlet2, torch.float64, MG_LEVELS,
                        device)
    return mesh, st, inlet1


def port_levels(st, kernel, w):
    """The port's V-cycle levels (``solve/mg.py::galerkin_levels``) of
    ``st``'s operator at ``kernel``'s Jacobian at ``w``."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered \
        import matrix_values_layered
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.mg import (
        galerkin_levels)

    lp, a = st.lp, st.lp.arrays
    vals = matrix_values_layered(kernel, lp.E, lp.n_planes, lp.bs, a, w)
    return galerkin_levels(st.mg, vals, a.cols, a.row_ids, a.row_ptr,
                           a.diag_pos, st.mask, lp.n2d, lp.n_planes)


def port_shape(mesh, st) -> dict:
    """``problem_shape`` of the port's build (``flow/channel.py::
    _setup_layered``'s ``LayeredSetup`` on ``mesh``)."""
    lp = st.lp
    return problem_shape(mesh.n_cells, lp.ndofs, lp.n2d, lp.n_planes, lp.E,
                         st.mg.dims, lp.rows2d, lp.cols2d,
                         st.mask.cpu().numpy(), st.g64.cpu().numpy())


def check_shape(got: dict, ref: dict) -> list:
    """Rows ``(what, ok, detail)``: every count and checksum of ``got``
    (``problem_shape`` of the port's build) against the fixture's."""
    rows = []
    for key in ("n_cells", "ndofs", "n2d", "n_planes", "E", "n_fixed",
                "pattern_sha", "mask_sha"):
        rows.append((f"{key} equal", got[key] == ref[key],
                     f"{got[key]} vs {ref[key]}"))
    same = np.array_equal(got["dims"], ref["dims"])
    rows.append(("V-cycle levels' (n2d, Lp, E) equal", same,
                 f"{got['dims'].tolist()} vs {ref['dims'].tolist()}"))
    for key in ("g_norm", "g_proj"):
        r = abs(got[key] - ref[key]) / abs(ref[key])
        rows.append((f"{key} within relative {G_REL:g}", bool(r <= G_REL),
                     f"{got[key]!r} vs {ref[key]!r} (relative {r:.2e})"))
    return rows


def sample_indices(ndofs: int) -> np.ndarray:
    """The ``N_SAMPLE`` dofs the converged field is kept at (sorted)."""
    return np.sort(np.random.default_rng(0).choice(
        ndofs, N_SAMPLE, replace=False))


def part(refs: dict, name: str) -> dict:
    """The keys of part ``name`` of a loaded fixture, without the prefix."""
    pre = f"{name}__"
    return {k[len(pre):]: v for k, v in refs.items() if k.startswith(pre)}


def load(path=FIXTURE) -> dict:
    """The fixture as a dict of numpy values (scalars as Python numbers,
    strings as str); a part not yet generated is absent."""
    with np.load(path) as f:
        out = {}
        for k in f.files:
            v = f[k]
            if v.ndim == 0:
                v = v.item()
            out[k] = v
    return out


def _save(new: dict) -> None:
    old = load() if FIXTURE.exists() else {}
    old.update(new)
    np.savez_compressed(FIXTURE, **{k: np.asarray(v) for k, v in old.items()})
    print(f"{FIXTURE}: {FIXTURE.stat().st_size} bytes", flush=True)


def generate(parts=PARTS) -> dict:
    """Run the JAX package on the CPU in float64 for ``parts`` and merge
    each into ``FIXTURE`` as it finishes."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from stabilized_navier_stokes_flow_fenicsx_tpu.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu.flow import channel
    from stabilized_navier_stokes_flow_fenicsx_tpu.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes \
        import make_ns_sups_kernel
    from stabilized_navier_stokes_flow_fenicsx_tpu.solve.driver import (
        solve_newton_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu.utils.testimg import (
        make_annulus_image)

    tmp = tempfile.TemporaryDirectory()
    img = make_annulus_image(f"{tmp.name}/circle.png", "circle")
    out = {"jax_version": jax.__version__}
    if "shape" in parts or "headline" in parts:
        t0 = time.perf_counter()
        inlet1, inlet2 = solve_inlet_profiles(img, RATIO, DEFAULT)
        mesh, _, _ = channel.generate_channel_mesh(img, LC, DEFAULT,
                                                   layered=True)
        W, lp, mask, g, g64, hier = channel._setup_layered(
            mesh, inlet1, inlet2, mg_levels=MG_LEVELS)
        setup_s = time.perf_counter() - t0
        shape = problem_shape(
            mesh.n_cells, W.ndofs, lp.n2d, lp.n_planes, lp.E, hier.dims,
            np.asarray(lp.pattern_like.row_ids),
            np.asarray(lp.pattern_like.indices), np.asarray(mask), g64)
        print(f"shape ({setup_s:.1f} s): "
              f"{ {k: v for k, v in shape.items() if 'sha' not in k} }",
              flush=True)
        out.update({f"shape__{k}": v for k, v in shape.items()},
                   shape__setup_s=setup_s)
        _save(out)
    if "headline" in parts:
        kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / RE)
        h = HEADLINE
        w, rows, walls = g, [], []
        for _ in range(h["steps"]):
            t0 = time.perf_counter()
            res = solve_newton_layered(
                kern, lp.n2d, lp.n_planes, lp.bs, lp.arrays, mask, g, w,
                lp.E, 0.0, 0.0, 1, h["ksp_rtol"], h["ksp_restart"],
                h["ksp_max_restarts"], h["pc"], hier)
            w = res.x
            rows.append(np.asarray(res.history)[0])
            walls.append(time.perf_counter() - t0)
            print(f"headline step {len(rows)}: [|F|, lambda, its, |r|] = "
                  f"{rows[-1].tolist()} ({walls[-1]:.1f} s)", flush=True)
        rows = np.asarray(rows, np.float64)
        out.update(headline__fnorm=rows[:, 0], headline__lam=rows[:, 1],
                   headline__its=rows[:, 2].astype(np.int64),
                   headline__wall_s=np.asarray(walls))
        _save(out)
    if "converged" in parts or "re40" in parts:
        calls = []
        lin, newton = channel.solve_linear_layered, \
            channel.solve_newton_layered_stepped

        def lin_rec(*a, **k):
            res = lin(*a, **k)
            calls.append(("stokes", int(res.iters)))
            return res

        def newton_rec(*a, **k):
            res = newton(*a, **k)
            calls.append(("newton", int(res.iters)))
            return res

        channel.solve_linear_layered = lin_rec
        channel.solve_newton_layered_stepped = newton_rec
        try:
            t0 = time.perf_counter()
            sol = channel.solve_ns_flow(RE, img, RATIO, LC, coarse_lc=LC)
            wall = time.perf_counter() - t0
        finally:
            channel.solve_linear_layered = lin
            channel.solve_newton_layered_stepped = newton
        newton_its = [c[1] for c in calls if c[0] == "newton"]
        stokes_its = [c[1] for c in calls if c[0] == "stokes"]
        w = np.asarray(sol.w, np.float64)
        idx = sample_indices(len(w))
        out.update(
            converged__converged=bool(sol.converged),
            converged__stokes_its=int(sum(stokes_its)),
            converged__newton_its=int(sum(newton_its)),
            converged__newton_its_per_call=np.asarray(newton_its),
            converged__fnorm=float(sol.newton_resnorm),
            converged__u_norm=float(np.linalg.norm(sol.u)),
            converged__p_norm=float(np.linalg.norm(sol.p)),
            converged__idx=idx, converged__w=w[idx],
            converged__wall_s=wall)
        print(f"converged ({wall:.1f} s): {sol.converged}, Stokes "
              f"{stokes_its}, Newton {newton_its}, |F| "
              f"{sol.newton_resnorm:.3e}", flush=True)
        _save(out)
    if "re40" in parts:
        from stabilized_navier_stokes_flow_fenicsx_tpu.trace.pipeline import (
            for_and_rev_streamtrace)

        t0 = time.perf_counter()
        sol40 = channel.solve_ns_flow(40.0, img, RATIO, LC, coarse_lc=LC,
                                      warm=sol)
        wall = time.perf_counter() - t0
        w = np.asarray(sol40.w, np.float64)
        out.update(
            re40__converged=bool(sol40.converged),
            re40__newton_its=int(sol40.newton_iters),
            re40__fnorm=float(sol40.newton_resnorm),
            re40__u_norm=float(np.linalg.norm(sol40.u)),
            re40__p_norm=float(np.linalg.norm(sol40.p)),
            re40__w=w[idx], re40__wall_s=wall)
        print(f"re40 ({wall:.1f} s): {sol40.converged}, Newton "
              f"{sol40.newton_iters}, |F| {sol40.newton_resnorm:.3e}",
              flush=True)
        _save(out)
        inlet1, _ = solve_inlet_profiles(img, RATIO, DEFAULT)
        t0 = time.perf_counter()
        res = for_and_rev_streamtrace(200, img, sol40.mesh,
                                      np.asarray(sol40.u),
                                      inlet1.mesh.points, DEFAULT)
        wall = time.perf_counter() - t0
        st = res.stats
        out.update(
            trace__n_outlet_points=len(res.outlet_points),
            trace__n_forward_kept=len(res.forward_endpoints),
            trace__seed_steps=int(st["seed_steps"]),
            trace__lane_steps=int(st["lane_steps"]),
            trace__seeds=int(st["seeds"]), trace__wall_s=wall)
        print(f"trace ({wall:.1f} s): outlet points "
              f"{len(res.outlet_points)}, kept forward "
              f"{len(res.forward_endpoints)}, seed_steps "
              f"{st['seed_steps']}, lane_steps {st['lane_steps']}",
              flush=True)
        # the same field traced in float32, as round 5 traced it
        t0 = time.perf_counter()
        with jax.enable_x64(False):
            res = for_and_rev_streamtrace(
                200, img, sol40.mesh, np.asarray(sol40.u, np.float32),
                inlet1.mesh.points, DEFAULT)
        wall = time.perf_counter() - t0
        st = res.stats
        out.update(
            trace__f32_n_outlet_points=len(res.outlet_points),
            trace__f32_n_forward_kept=len(res.forward_endpoints),
            trace__f32_seed_steps=int(st["seed_steps"]),
            trace__f32_lane_steps=int(st["lane_steps"]),
            trace__f32_wall_s=wall)
        print(f"trace in float32 ({wall:.1f} s): outlet points "
              f"{len(res.outlet_points)}, kept forward "
              f"{len(res.forward_endpoints)}, seed_steps "
              f"{st['seed_steps']}, lane_steps {st['lane_steps']}",
              flush=True)
        _save(out)
    tmp.cleanup()
    return out


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    generate(tuple(sys.argv[1:]) or PARTS)
