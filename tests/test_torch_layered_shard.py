"""The port's plane-sharded layered path (parallel/layered_shard.py): its
tables and slab assembly on several gloo ranks, against the JAX package.
Float64 on the CPU; the rank processes run tests/torch_dist_cases.py.
The sharded Newton solves are in tests/test_torch_layered_shard_duct.py
and tests/test_torch_layered_shard_channel.py (one file each, so that
the test run's workers take them side by side).

* ``padded_planes``, ``pad_mask_g``, ``build_slab_layered``: equal to the
  JAX package's on the same mesh (tables ``np.array_equal``, ``meta``
  equal), on the duct (6, 13) and the CHANNEL mesh, 2 and 4 ranks;
* ``make_slab_assembly``'s ``residual_fn`` and ``values_fn`` and the slab
  SpMV (``SlabOperand``): the ranks' planes joined against the JAX
  package's single-device ``residual_layered``, ``matrix_values_layered``
  and projected ``layered_matvec``, relative 1e-12; each rank's cell count
  is the slab partition's ``meta["counts"]``;
* without a process group the entry point is the single-process solve.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import (  # noqa: E402
    layered as jax_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu.parallel import (  # noqa: E402
    layered_shard as jax_shard)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (  # noqa: E402
    build_layered, matrix_values_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import (  # noqa: E402
    layered_shard)

from torch_cases import rel_l2  # noqa: E402
from torch_dist_cases import padded_pattern, run_ranks  # noqa: E402
from torch_shard_cases import (RANKS, TOLS, _params, img,  # noqa: E402,F401
                               problems)


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
