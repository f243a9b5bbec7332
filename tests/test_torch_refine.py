"""Iterative refinement (``SolverConfig.refine``) on the layered main
path: the port against the JAX package's double-float refinement, on the
CPU.

The port refines a float32 solve with an f64 residual on f64 geometry;
the JAX package with a two-f32 residual.  Both aim at the same f64
solution, so the bars are the stored CPU-f64 fixture (relative L2
< 1e-6, tests/test_parity.py's bar for its f32 + refinement cases) and
the JAX package's step counts on the same problem:

* the CHANNEL case in float32 (``refine="auto"``): refined, converged,
  |w + w_lo - channel_ns.npz| < 1e-6 with w (f32) and w_lo its exact
  split; refinement steps and fine Newton steps within +-1 of JAX's (2
  and 1), the base Newton's flag equal (False: an f32 Newton cannot
  reach 1e-8).  The f32 Stokes start at rtol 1e-8 sits at float32's
  rounding floor in both packages and so runs all 80 FGMRES restarts in
  both (JAX 231 iterations, the port ~270: two or three Arnoldi steps a
  cycle at the floor; tests/torch_refine_report.py prints both); the bar
  is that neither converges and that the two floors agree within 2x;
* the warm sweep path in float32 refines and converges after a Newton
  that ended on its step budget; ``refine="off"`` returns the f32 Newton;
* the f64 geometry the residual assembles on (``layered_arrays_in``,
  ``asm_arrays_in``) is an f64 build's, bit for bit;
* ``refine_newton`` on a dense toy: a step that fails to reduce ||F||
  stops the loop with the better iterate kept, and x_hi + x_lo is the
  f64 iterate exactly.

The block-CSR path is tests/test_torch_refine_bcsr.py.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.config import (  # noqa: E402
    SolverConfig as JaxSolverConfig)
from stabilized_navier_stokes_flow_fenicsx_tpu.flow import (  # noqa: E402
    channel as jax_channel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    asm_arrays_in, assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (  # noqa: E402
    build_layered, layered_arrays_in)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (  # noqa: E402
    DEFAULT, SolverConfig)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow import (  # noqa: E402
    channel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    refine)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import (  # noqa: E402
    channel_image, recording, rel_l2, split_exact)


def _solve_recording_stokes(module, solve, *args, **kwargs):
    """(solve(*args, **kwargs), the Stokes start's Krylov result)."""
    calls = []
    fn = recording(module, "solve_linear_layered", calls)
    try:
        out = solve(*args, **kwargs)
    finally:
        module.solve_linear_layered = fn
    (stokes,) = calls
    return out, stokes


@pytest.fixture(scope="module")
def img(tmp_path_factory):
    return channel_image(tmp_path_factory.mktemp("refine"))


@pytest.fixture(scope="module")
def port_f32(img):
    return _solve_recording_stokes(
        channel, channel.solve_ns_flow, CHANNEL["Re"], img, CHANNEL["ratio"],
        channel_mesh_size=CHANNEL["lc"], coarse_lc=CHANNEL["lc"],
        dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def jax_f32(img):
    return _solve_recording_stokes(
        jax_channel, jax_channel.solve_ns_flow, CHANNEL["Re"], img,
        CHANNEL["ratio"], channel_mesh_size=CHANNEL["lc"],
        coarse_lc=CHANNEL["lc"], dtype=jnp.float32)


def test_f32_channel_refines_to_the_fixture(port_f32):
    sol, _ = port_f32
    assert sol.refined and sol.converged
    assert sol.refine_iters <= DEFAULT.solver.refine_max_it
    assert sol.refine_resnorm <= DEFAULT.solver.newton_atol
    w64 = split_exact(sol.w, sol.w_lo)
    w_ref = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    assert rel_l2(w64, w_ref) < 1e-6
    u, p = sol.space.split(w64)
    assert np.array_equal(sol.u, u) and np.array_equal(sol.p, p)
    # the refine rows: [|F|, lambda = 1 (full steps), FGMRES its, |r|]
    h = sol.newton_history["refine"]
    assert h.shape == (sol.refine_iters, 4) and (h[:, 1] == 1.0).all()
    assert h[:, 0].min() == sol.refine_resnorm
    assert set(sol.timings) >= {"stokes", "coarse_ns", "fine_ns", "refine"}


def test_f32_channel_counts_match_jax(port_f32, jax_f32):
    sol, _ = port_f32
    ref, _ = jax_f32
    assert bool(ref.refined) and bool(ref.converged)
    assert abs(sol.refine_iters - int(ref.refine_iters)) <= 1
    assert abs(sol.newton_iters - int(ref.newton_iters)) <= 1
    assert sol.base_converged == bool(ref.base_converged)
    w_ref = np.asarray(ref.w, np.float64) + np.asarray(ref.w_lo)
    assert rel_l2(sol.w.astype(np.float64) + sol.w_lo, w_ref) < 1e-6


def test_f32_stokes_start_floors_as_jax(port_f32, jax_f32):
    """rtol 1e-8 is below float32's floor for the Stokes start: in both
    packages FGMRES ends on its restart budget (not converged after 80
    cycles), at residual floors within 2x of each other."""
    (sol, stokes), (_, jstokes) = port_f32, jax_f32
    assert not stokes.converged and not bool(jstokes.converged)
    assert sol.stokes_iters == stokes.iters
    assert stokes.iters >= 50 + 79 and int(jstokes.iters) >= 50 + 79
    floor, jfloor = stokes.resnorm, float(jstokes.resnorm)
    assert 0.5 < floor / jfloor < 2.0, (stokes.iters, int(jstokes.iters))


def test_warm_sweep_f32_refines(img, port_f32):
    """The Re=20 warm path in float32 with a fine Newton budget of 4
    steps: the Newton ends on its budget at float32's floor (it would
    spend its 30 steps there, backtracking), and refinement runs after it
    all the same."""
    sol, _ = port_f32
    cfg = dataclasses.replace(DEFAULT, solver=SolverConfig(newton_max_it=4))
    warm = channel.solve_ns_flow(20.0, img, CHANNEL["ratio"],
                                 channel_mesh_size=CHANNEL["lc"], cfg=cfg,
                                 warm=sol, dtype=torch.float32, device="cpu")
    assert warm.newton_iters == 4 and not warm.base_converged
    assert warm.refined and warm.converged
    assert warm.refine_resnorm <= DEFAULT.solver.newton_atol
    assert set(warm.timings) == {"inlet_profiles", "fine_mesh",
                                 "fine_setup", "fine_ns", "refine"}
    assert list(warm.newton_history) == ["fine_ns", "refine"]
    w64 = split_exact(warm.w, warm.w_lo)
    assert rel_l2(w64, sol.w.astype(np.float64) + sol.w_lo) > 1e-3


def test_refine_off_returns_the_f32_newton(img, port_f32):
    sol, _ = port_f32
    cfg = dataclasses.replace(DEFAULT, solver=SolverConfig(
        refine="off", newton_max_it=2))
    off = channel.solve_ns_flow(CHANNEL["Re"], img, CHANNEL["ratio"],
                                channel_mesh_size=CHANNEL["lc"], cfg=cfg,
                                warm=sol, dtype=torch.float32, device="cpu")
    assert not off.refined and off.w_lo is None and off.refine_iters == 0
    assert off.w.dtype == np.float32 and "refine" not in off.timings
    assert list(off.newton_history) == ["fine_ns"]
    # the f32 Newton alone stays at float32's floor, short of 1e-8, and
    # reports its own flag
    assert off.newton_resnorm > DEFAULT.solver.newton_atol
    assert not off.converged
    assert rel_l2(off.w, sol.w.astype(np.float64) + sol.w_lo) < 1e-6


def test_f64_geometry_is_an_f64_build(img):
    """``layered_arrays_in`` and ``asm_arrays_in`` rebuild the float32
    arrays' coordinates as an f64 build has them, bit for bit, and share
    the index tables; arrays already in f64 come back as they are."""
    mesh, _, _ = channel.generate_channel_mesh(img, CHANNEL["lc"])
    W = make_mixed_space(mesh, 1, 1)
    n2d, n_planes, _ = mesh.layered
    lp32, lp64 = (build_layered(W, n2d, n_planes, dt, "cpu")
                  for dt in (torch.float32, torch.float64))
    a = layered_arrays_in(lp32.arrays, mesh, torch.float64)
    b = lp64.arrays
    for got, want in ((a.cell_coords, b.cell_coords),
                      (a.sasm.cell_coords, b.sasm.cell_coords),
                      (a.sasm.coordsT, b.sasm.coordsT)):
        assert got.dtype == torch.float64 and torch.equal(got, want)
    assert a.cell_dofs is lp32.arrays.cell_dofs
    assert a.sasm.rtab is lp32.arrays.sasm.rtab
    assert layered_arrays_in(b, mesh, torch.float64) is b
    no_ids = dataclasses.replace(lp32.arrays, sasm=dataclasses.replace(
        lp32.arrays.sasm, cell_ids=None))
    with pytest.raises(ValueError, match="cell_ids"):
        layered_arrays_in(no_ids, mesh, torch.float64)

    asm32, asm64 = (assembler_for_mixed(W, dtype=dt, device="cpu")
                    for dt in (torch.float32, torch.float64))
    c = asm_arrays_in(asm32.arrays, mesh, torch.float64)
    assert torch.equal(c.cell_coords, asm64.arrays.cell_coords)
    assert c.ell_pos is asm32.arrays.ell_pos
    assert asm_arrays_in(asm64.arrays, mesh, torch.float64) \
        is asm64.arrays


def _toy(n=24, seed=0):
    """A dense, well-conditioned f64 system F(x) = A x - b."""
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) * 0.3
    b = rng.standard_normal(n)
    A64, b64 = torch.as_tensor(A), torch.as_tensor(b)
    return A64, b64, (lambda x: A64 @ x - b64)


def _dense_op(vals):
    return lambda x: vals @ x


def test_refine_keeps_the_better_iterate_and_stops():
    A64, b64, residual64 = _toy()
    jacs = [A64.float(), -A64.float(), A64.float()]   # step 2 is wrong

    def jac_values(x):
        return jacs.pop(0)

    x0 = torch.zeros(len(b64), dtype=torch.float32)
    out = refine.refine_newton(residual64, jac_values, _dense_op,
                               lambda vals: None, x0, n0=1.0, rtol=0.0,
                               atol=1e-14, max_it=10, ksp_rtol=1e-6)
    assert out.iters == 2 and not out.converged and len(jacs) == 1
    assert out.history.shape == (2, 3)
    assert out.history[1, 0] > out.history[0, 0]      # the failed step
    assert out.resnorm == out.history[0, 0]           # step 1 kept
    assert float(torch.linalg.vector_norm(residual64(out.x))) \
        == out.resnorm


def test_refine_split_is_exact():
    A64, b64, residual64 = _toy(seed=1)
    x0 = torch.zeros(len(b64), dtype=torch.float32)
    out = refine.refine_newton(residual64, lambda x: A64.float(), _dense_op,
                               lambda vals: None, x0, n0=1.0, rtol=0.0,
                               atol=1e-13, max_it=10, ksp_rtol=1e-4)
    assert out.converged and out.iters >= 2
    assert out.resnorm < 1e-13 < float(torch.linalg.vector_norm(
        residual64(out.x_hi.double())))
    # x_hi is the f64 iterate rounded to f32, x_lo the exact remainder
    x = out.x
    assert torch.equal(x.float(), out.x_hi)
    assert torch.equal(x - out.x_hi.double(), out.x_lo)
    assert float(torch.linalg.vector_norm(residual64(x))) == out.resnorm
    assert float((x - torch.linalg.solve(A64, b64)).abs().max()) < 1e-13


def test_refine_enabled_modes():
    assert refine.refine_enabled("auto", torch.float32)
    assert not refine.refine_enabled("auto", torch.float64)
    assert refine.refine_enabled("on", torch.float64)
    assert not refine.refine_enabled("off", torch.float32)
    # the refinement budgets are the JAX package's
    names = ("refine", "refine_max_it", "refine_ksp_rtol",
             "refine_ksp_max_restarts")
    assert [getattr(SolverConfig(), k) for k in names] \
        == [getattr(JaxSolverConfig(), k) for k in names]
