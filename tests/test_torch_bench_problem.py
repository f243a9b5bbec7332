"""The port at bench.py's problem (the circle image, ratio 0.5,
lc=0.024: 1,053,696 dofs), on the CPU, against the JAX package.

* The port's build (``generate_channel_mesh`` + ``_setup_layered(...,
  mg_levels=3)``) has the counts and checksums of
  tests/fixtures/bench_refs.npz (the JAX package's build, written by
  tests/torch_bench_refs.py): cells, dofs, n2d, Lp, E, the V-cycle
  levels, the layered pattern and the BC mask exactly, the BC values to
  relative 1e-12.
* K2's launch plan (``solve/plane_gs.py::make_plan``) on that level 0:
  a cluster of 16 blocks of 512 threads, one thread per (row,
  component), so a stage takes two passes of the block (173 rows); the
  values read from device memory in (f64, f64), a ring of 4 slices in
  (bf16, f32) and of 3 in (f32, f32), with the shared memory those take.
* The headline's Newton step (``bench.py::aot_newton_step``: ``max_it=1``
  from g, ksp_rtol 1e-3, restart 50, 4 restarts, ``mg_cheby6_bf16``) at
  the CHANNEL size: FGMRES iterations within 1 of JAX's, line-search
  lambda equal, |F(g)| within 1e-12 relative and |F| after the step
  within 1e-6 relative (1.2e-7 measured): the step solves to ksp_rtol
  1e-3 through bf16 smoothers, which round the f32 iterate in the port
  and the f64 one in JAX, so the steps differ by far more than the
  f64 residual's own 1e-12.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel as jax_ns_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.solve import (  # noqa: E402
    driver as jax_driver)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    driver, plane_gs)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (  # noqa: E402
    make_annulus_image)

import torch_bench_refs as refs  # noqa: E402
from parity_fixtures import CHANNEL  # noqa: E402
from torch_cases import channel_image, jax_channel, port_state  # noqa: E402


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The port's build of the bench problem on the CPU: (mesh, setup)."""
    img = make_annulus_image(
        str(tmp_path_factory.mktemp("bench") / "circle.png"), "circle")
    mesh, st, _ = refs.port_problem(img, "cpu")
    return mesh, st


def test_fixture_holds_every_part():
    """bench_refs.npz holds what chip_smoke.py phase 19 reads: every part
    of ``PARTS`` (the trace, in f64 and in f32, within ``re40``), each
    solve converged."""
    got = refs.load()
    for name in refs.PARTS + ("trace",):
        assert refs.part(got, name), name
    assert {"seed_steps", "f32_seed_steps"} <= set(refs.part(got, "trace"))
    assert got["converged__converged"] and got["re40__converged"]
    assert len(got["converged__idx"]) == len(got["converged__w"]) \
        == len(got["re40__w"]) == refs.N_SAMPLE
    assert np.array_equal(got["converged__idx"],
                          refs.sample_indices(got["shape__ndofs"]))
    assert len(got["headline__its"]) == refs.HEADLINE["steps"]


def test_bench_problem_matches_the_jax_build(bench):
    rows = refs.check_shape(refs.port_shape(*bench),
                            refs.part(refs.load(), "shape"))
    assert all(ok for _, ok, _ in rows), [r for r in rows if not r[1]]


# (values, iterate, value ring slots, shared memory a block): level 0's
# 173 rows and 883 pairs a block
LEVEL0_PLANS = [(torch.float64, torch.float64, 0, 103_936),
                (torch.bfloat16, torch.float32, 4, 156_064),
                (torch.float32, torch.float32, 3, 223_648)]


@pytest.mark.parametrize("vdtype, adtype, slots, nbytes", LEVEL0_PLANS)
def test_level0_plan(bench, vdtype, adtype, slots, nbytes):
    lp = bench[1].lp
    row_ptr = lp.arrays.row_ptr.numpy()
    plan = plane_gs.make_plan(
        row_ptr, lp.cols2d, torch.tensor([], dtype=vdtype).element_size(),
        torch.tensor([], dtype=adtype).element_size())
    assert (plan.cluster, plan.split, plan.threads) == (16, 1, 512)
    assert (plan.max_rows, plan.max_pairs) == (173, 883)
    assert 4 * plan.max_rows * plan.split > plan.threads   # two passes
    assert plan.slots == slots and plan.staged == bool(slots)
    assert plan.smem_bytes == nbytes <= plane_gs.SMEM_LIMIT
    # every pair's column lies in the block that owns it
    owner = plan.colcode & 15
    local = plan.colcode >> 4
    assert np.array_equal(plan.blocks[owner, 0] + local, lp.cols2d)


@pytest.fixture(scope="module")
def channel(tmp_path_factory):
    img = channel_image(tmp_path_factory.mktemp("headline"))
    mesh, W, lp, mask, g, hier = jax_channel(img)
    return lp, mask, g, hier, port_state(lp, mask, g, hier)


def test_headline_newton_step(channel):
    lp, mask, g, hier, (arrays, mask_t, g_t, hier_t) = channel
    h = refs.HEADLINE
    tail = (lp.E, 0.0, 0.0, 1, h["ksp_rtol"], h["ksp_restart"],
            h["ksp_max_restarts"], h["pc"])
    nu = 1.0 / CHANNEL["Re"]
    ref = jax_driver.solve_newton_layered(
        jax_ns_kernel("tetrahedron", nu=nu), lp.n2d, lp.n_planes, lp.bs,
        lp.arrays, mask, g, g, *tail, hier)
    out = driver.solve_newton_layered(
        make_ns_sups_kernel("tetrahedron", nu), lp.n2d, lp.n_planes, lp.bs,
        arrays, mask_t, g_t, g_t, *tail, hier_t)
    f0 = float(jax_driver.residual_norm_layered(
        jax_ns_kernel("tetrahedron", nu=nu), lp.n2d, lp.n_planes, lp.bs,
        lp.arrays, mask, g, jnp.asarray(g), lp.E))
    f0_t = driver.residual_norm_layered(
        make_ns_sups_kernel("tetrahedron", nu), lp.n2d, lp.n_planes, lp.bs,
        arrays, mask_t, g_t, g_t, lp.E)
    h_ref = np.asarray(ref.history)[0]
    assert out.iters == int(ref.iters) == 1 and not out.stalled
    assert abs(f0_t - f0) <= 1e-12 * f0
    assert abs(out.history[0, 2] - h_ref[2]) <= 1, (out.history, h_ref)
    assert out.history[0, 1] == h_ref[1]
    assert abs(out.history[0, 0] - h_ref[0]) <= 1e-6 * h_ref[0], \
        (out.history, h_ref)
