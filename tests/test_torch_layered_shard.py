"""The port's plane-sharded layered path (parallel/layered_shard.py) on
several gloo ranks, against the JAX package and the port's single-process
solves.  Float64 on the CPU; the rank processes run
tests/torch_dist_cases.py.

* ``padded_planes``, ``pad_mask_g``, ``build_slab_layered``: equal to the
  JAX package's on the same mesh (tables ``np.array_equal``, ``meta``
  equal), on the duct (6, 13) and the CHANNEL mesh, 2 and 4 ranks;
* ``make_slab_assembly``'s ``residual_fn`` and ``values_fn`` and the slab
  SpMV (``SlabOperand``): the ranks' planes joined against the JAX
  package's single-device ``residual_layered``, ``matrix_values_layered``
  and projected ``layered_matvec``, relative 1e-12; each rank's cell count
  is the slab partition's ``meta["counts"]``;
* ``sharded_newton_layered`` with ``pc="jacobi"`` and ``pc="mg"``: against
  the port's single-process solve (block-CSR Newton on the duct,
  ``solve_newton_layered`` with ``mg_cheby`` on the CHANNEL mesh) and
  against the JAX package's ``sharded_newton_layered`` on as many devices,
  relative L2 < 1e-8 with equal Newton step counts; padded-plane dofs
  exactly 0 (under the V-cycle on the CHANNEL mesh: 0 to 1e-14 of the
  largest dof).
"""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import (  # noqa: E402
    layered as jax_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu.parallel import (  # noqa: E402
    layered_shard as jax_shard)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (  # noqa: E402
    build_layered, matrix_values_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import (  # noqa: E402
    layered_shard)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (  # noqa: E402
    solve_newton_bcsr, solve_newton_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.mg import (  # noqa: E402
    build_mg_hierarchy)

import test_layered_shard as jax_cases  # noqa: E402
from parity_fixtures import CHANNEL  # noqa: E402
from torch_cases import channel_image, rel_l2  # noqa: E402
from torch_dist_cases import (channel_problem, duct_problem,  # noqa: E402
                              padded_pattern, run_ranks)

TOLS = dict(rtol=1e-12, atol=1e-12, max_it=30, ksp_rtol=1e-10)
RANKS = (2, 4)


@pytest.fixture(scope="module")
def img(tmp_path_factory):
    return channel_image(tmp_path_factory.mktemp("layered_shard"))


def _params(geometry, img):
    if geometry == "duct":
        return dict(geometry="duct", n_cross=6, n_axial=13, Re=20.0)
    return dict(geometry="channel", img=img, lc=CHANNEL["lc"],
                Re=CHANNEL["Re"])


@pytest.fixture(scope="module")
def problems(img):
    """{geometry: (JAX problem, port problem)}: (mesh, W, mask, g, kernel)
    of each package, built from the same parameters."""
    from stabilized_navier_stokes_flow_fenicsx_tpu.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu.fem.bc import (
        DirichletBC, bc_mask, bc_vector, combine_bcs)
    from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu.flow.channel import (
        channel_bcs, generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (
        make_ns_sups_kernel)

    inlet1, inlet2 = solve_inlet_profiles(img, CHANNEL["ratio"], DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, CHANNEL["lc"], DEFAULT,
                                       layered=True)
    W = make_mixed_space(mesh, 1, 1)
    _n2d, _Lp, used = mesh.layered
    unused = np.nonzero(~used)[0].astype(np.int64)
    unused_dofs = (unused[:, None] * 4 + np.arange(4)[None, :]).ravel()
    bc = combine_bcs([DirichletBC(unused_dofs, np.zeros(len(unused_dofs))),
                      channel_bcs(mesh, W, inlet1, inlet2)])
    jax_channel = (mesh, W, bc_mask(W.ndofs, bc).astype(np.float64),
                   bc_vector(W.ndofs, bc),
                   make_ns_sups_kernel("tetrahedron",
                                       nu=1.0 / CHANNEL["Re"]))
    return dict(
        duct=(jax_cases._duct_layered(), duct_problem()),
        channel=(jax_channel,
                 channel_problem(img, CHANNEL["lc"], CHANNEL["Re"])))


def test_same_problem_in_both_packages(problems):
    for (jm, jW, jmask, jg, _), (tm, tW, tmask, tg, _) in problems.values():
        assert np.array_equal(jm.cells, tm.cells)
        np.testing.assert_allclose(jm.points, tm.points, rtol=0, atol=1e-14)
        assert np.array_equal(jmask, tmask)
        np.testing.assert_allclose(jg, tg, rtol=0, atol=1e-14)


@pytest.mark.parametrize("n_planes, D", [(14, 2), (14, 4), (27, 4), (24, 8),
                                         (1, 3)])
def test_padded_planes_and_pad_mask_g(n_planes, D):
    Lp = layered_shard.padded_planes(n_planes, D)
    assert Lp == jax_shard.padded_planes(n_planes, D) and Lp % D == 0
    rng = np.random.default_rng(0)
    mask = (rng.random(n_planes * 8) > 0.3).astype(np.float64)
    g = rng.standard_normal(n_planes * 8)
    out = layered_shard.pad_mask_g(mask, g, Lp * 8)
    ref = jax_shard.pad_mask_g(mask, g, Lp * 8)
    for a, b in zip(out, ref):
        assert np.array_equal(a, b) and a.shape == (Lp * 8,)


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("geometry", ["duct", "channel"])
def test_build_slab_layered_equals_jax(problems, geometry, D):
    (jm, jW, jmask, jg, _), (tm, tW, tmask, tg, _) = problems[geometry]
    n2d, Lp, _ = jm.layered
    jlp = jax_layered.build_layered(
        jW, n2d, jax_shard.padded_planes(Lp, D))
    jslab, jmeta = jax_shard.build_slab_layered(jlp, D)
    lp, _, _ = padded_pattern(tm, tW, tmask, tg, D)
    assert lp.arrays.sasm is None
    assert np.array_equal(lp.rows2d, np.asarray(jlp.pattern_like.row_ids))
    assert np.array_equal(lp.cols2d, np.asarray(jlp.pattern_like.indices))
    slab, meta = layered_shard.build_slab_layered(lp, D)
    for name in ("cell_dofs", "cell_coords", "ell_pos"):
        assert np.array_equal(getattr(slab, name),
                              np.asarray(getattr(jslab, name))), name
    assert set(meta) == set(jmeta)
    for key in ("Lq", "ncs", "ndofs_ext", "nseg_ext"):
        assert meta[key] == jmeta[key], key
    assert np.array_equal(meta["counts"], jmeta["counts"])
    # the partition divides the work: every cell once, slab-local ids
    # inside the (Lq+1)-plane block
    assert meta["counts"].sum() == tm.n_cells
    assert slab.cell_dofs.min() >= 0
    assert slab.cell_dofs.max() <= meta["ndofs_ext"]
    assert slab.ell_pos.min() >= 0
    assert slab.ell_pos.max() <= meta["nseg_ext"]


def test_structured_route_raises_without_a_plan(problems):
    tm, tW, tmask, tg, kern = problems["duct"][1]
    n2d, Lp, _ = tm.layered
    lp = build_layered(tW, n2d, Lp, device="cpu")
    assert lp.arrays.sasm is None
    with pytest.raises(ValueError, match="extrusion grid"):
        matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, lp.arrays,
                              torch.zeros(lp.ndofs, dtype=torch.float64))


@pytest.fixture(scope="module")
def single_device_assembly(problems):
    """{geometry: (w, x, r, V, y)}: the JAX package's single-device
    residual, values and projected matvec at a seeded state."""
    out = {}
    for geometry, ((jm, jW, jmask, jg, jkern), _) in problems.items():
        n2d, Lp, _ = jm.layered
        rng = np.random.default_rng(3)
        w = rng.standard_normal(jW.ndofs) * 0.1
        x = rng.standard_normal(jW.ndofs)
        jlp = jax_layered.build_layered(jW, n2d, Lp)
        r = jax_layered.residual_layered(
            jkern, n2d, Lp, jlp.bs, jlp.arrays, jnp.asarray(w))
        V = jax_layered.matrix_values_layered(
            jkern, jlp.E, Lp, jlp.bs, jlp.arrays, jnp.asarray(w))
        m = jnp.asarray(jmask)
        y = m * jax_layered.layered_matvec(jlp.arrays, n2d, Lp, V,
                                           m * jnp.asarray(x)) \
            + (1.0 - m) * jnp.asarray(x)
        out[geometry] = (w, x, np.asarray(r), np.asarray(V), np.asarray(y))
    return out


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("geometry", ["duct", "channel"])
def test_slab_assembly_matches_single_process(
        problems, single_device_assembly, img, tmp_path, geometry, D):
    (jm, jW, jmask, jg, jkern), (tm, tW, _, _, _) = problems[geometry]
    n2d, Lp, _ = jm.layered
    w, x, r_ref, V_ref, y_ref = single_device_assembly[geometry]
    res = run_ranks("slab_assembly", D, tmp_path, _params(geometry, img),
                    dict(w=w, x=x))
    r = np.concatenate([o["r"] for o in res])
    y = np.concatenate([o["y"] for o in res])
    V = np.concatenate([o["V"] for o in res], axis=-1)
    nd = jW.ndofs
    assert rel_l2(r[:nd], r_ref) <= 1e-12
    assert rel_l2(V[..., :Lp], V_ref) <= 1e-12
    assert rel_l2(y[:nd], y_ref) <= 1e-12
    # the padded planes: no cell adds to them, the operator is the
    # identity there (mask 0, x 0)
    assert np.abs(r[nd:]).max(initial=0.0) == 0.0
    assert np.abs(V[..., Lp:]).max(initial=0.0) == 0.0
    assert np.abs(y[nd:]).max(initial=0.0) == 0.0

    # each rank holds its own cells only: ncs rows, of which the slab
    # partition's count are real
    jlp_pad = jax_layered.build_layered(
        jW, n2d, jax_shard.padded_planes(Lp, D))
    _, jmeta = jax_shard.build_slab_layered(jlp_pad, D)
    for o in res:
        assert np.array_equal(o["counts"], jmeta["counts"])
        assert int(o["n_cells_local"]) == int(o["ncs"]) == jmeta["ncs"]
    assert int(res[0]["counts"].sum()) == tm.n_cells
    assert int(res[0]["counts"].max()) <= tm.n_cells / D \
        + 2 * tm.n_cells / (Lp - 1)


@pytest.fixture(scope="module")
def duct_single_process(problems):
    """The port's single-process Newton on the duct (block-CSR, node-block
    Jacobi) at the sharded tests' tolerances."""
    _, W, mask, g, kern = problems["duct"][1]
    asm = assembler_for_mixed(W, device="cpu")
    pat = asm.pattern
    out = solve_newton_bcsr(
        kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays,
        asm.vector(mask), asm.vector(g), asm.vector(g), **TOLS)
    assert out.converged
    return out


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("pc", ["jacobi", "mg"])
def test_plane_sharded_duct(problems, duct_single_process, tmp_path, pc, D):
    (jm, jW, jmask, jg, jkern), _ = problems["duct"]
    res = run_ranks("layered_newton", D, tmp_path,
                    dict(geometry="duct", n_cross=6, n_axial=13, Re=20.0,
                         pc=pc, mg_levels=2, tols=TOLS))
    nd = jW.ndofs
    n2d, Lp, _ = jm.layered
    Lp_pad = layered_shard.padded_planes(Lp, D)
    for o in res:
        assert bool(o["converged"])
        assert int(o["n_local"]) == n2d * Lp_pad * 4 // D
        assert np.array_equal(o["x"], res[0]["x"])
    x = res[0]["x"]
    assert x.shape == (n2d * Lp_pad * 4,)
    assert rel_l2(x[:nd], duct_single_process.x) < 1e-8
    # padded-plane dofs stayed at their identity value 0
    assert np.abs(x[nd:]).max(initial=0.0) == 0.0

    # the JAX package's sharded solve on as many devices
    dmesh = Mesh(np.array(jax.devices()[:D]), ("planes",))
    jlp = jax_layered.build_layered(jW, n2d, Lp_pad)
    mask_p, g_p = jax_shard.pad_mask_g(jmask, jg, n2d * Lp_pad * jlp.bs)
    ref = jax_shard.sharded_newton_layered(
        jkern, jlp, mask_p, g_p, g_p, dmesh, pc=pc, mg_levels=2, **TOLS)
    assert bool(ref.converged)
    assert int(res[0]["iters"]) == int(ref.iters)
    assert rel_l2(x, ref.x) < 1e-8
    its_ref = np.asarray(ref.history)[:int(ref.iters), 2]
    assert np.abs(res[0]["history"][:, 2] - its_ref).max() <= 1


@pytest.fixture(scope="module")
def channel_single_process(problems):
    """The port's single-process ``mg_cheby`` Newton on the CHANNEL mesh
    (structured assembly, the whole V-cycle in one process)."""
    tm, tW, mask, g, kern = problems["channel"][1]
    n2d, Lp, _ = tm.layered
    lp1 = build_layered(tW, n2d, Lp, device="cpu")
    hier = build_mg_hierarchy(lp1.rows2d, lp1.cols2d, n2d, Lp,
                              mask.astype(np.float32), lp1.bs, n_levels=2,
                              device="cpu")
    g_t = torch.as_tensor(g)
    out1 = solve_newton_layered(
        kern, n2d, Lp, lp1.bs, lp1.arrays, torch.as_tensor(mask), g_t, g_t,
        lp1.E, 1e-12, 1e-12, 30, 1e-10, 50, 40, "mg_cheby", hier)
    assert out1.converged
    return out1


@pytest.mark.parametrize("D", RANKS)
def test_plane_sharded_mg_channel(problems, channel_single_process, img,
                                  tmp_path, D):
    """pc="mg" on the CHANNEL mesh (splitter, unused-node rows, inlet
    profiles) against the port's single-process ``mg_cheby`` solve and
    the JAX package's sharded solve."""
    tm, tW, mask, g, kern = problems["channel"][1]
    out1 = channel_single_process
    res = run_ranks("layered_newton", D, tmp_path,
                    dict(pc="mg", mg_levels=2, tols=TOLS,
                         **_params("channel", img)))
    o = res[0]
    assert bool(o["converged"]) and int(o["iters"]) == out1.iters
    assert rel_l2(o["x"][:tW.ndofs], out1.x) < 1e-8
    # the V-cycle's prolongation pairs the first padded plane with the last
    # real one, so FGMRES pins the padded dofs to 0 only to its tolerance
    # (the exact 0 is the Jacobi case's, as in the JAX package's tests)
    assert np.abs(o["x"][tW.ndofs:]).max(initial=0.0) \
        <= 1e-14 * np.abs(o["x"]).max()
    assert np.abs(o["history"][:, 2] - out1.history[:, 2]).max() <= 1

    # the JAX package's sharded V-cycle solve on as many devices
    (jm, jW, jmask, jg, jkern), _ = problems["channel"]
    n2d, Lp, _ = jm.layered
    Lp_pad = layered_shard.padded_planes(Lp, D)
    dmesh = Mesh(np.array(jax.devices()[:D]), ("planes",))
    jlp = jax_layered.build_layered(jW, n2d, Lp_pad)
    mask_p, g_p = jax_shard.pad_mask_g(jmask, jg, n2d * Lp_pad * jlp.bs)
    ref = jax_shard.sharded_newton_layered(
        jkern, jlp, mask_p, g_p, g_p, dmesh, pc="mg", mg_levels=2, **TOLS)
    assert bool(ref.converged)
    assert int(o["iters"]) == int(ref.iters)
    assert rel_l2(o["x"], ref.x) < 1e-8
    its_ref = np.asarray(ref.history)[:int(ref.iters), 2]
    assert np.abs(o["history"][:, 2] - its_ref).max() <= 1


def test_single_process_without_a_group(problems):
    """No process group: the sharded entry point is the single-process
    solve on the whole channel (one slab), with no collective."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    tm, tW, mask, g, kern = problems["duct"][1]
    lp, mask_p, g_p = padded_pattern(tm, tW, mask, g, 1)
    out = layered_shard.sharded_newton_layered(
        kern, lp, mask_p, g_p, g_p, device="cpu", pc="mg", mg_levels=2,
        **TOLS)
    assert out.converged and out.x.numel() == tW.ndofs
    assert layered_shard.gather_dofs(out.x) is out.x
    with pytest.raises(ValueError, match="pc='ilu'"):
        layered_shard.sharded_newton_layered(
            kern, lp, mask_p, g_p, g_p, device="cpu", pc="ilu")
    with pytest.raises(ValueError, match="do not divide"):
        layered_shard.build_slab_layered(lp, 3)
