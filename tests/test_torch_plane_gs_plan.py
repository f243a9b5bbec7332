"""K2's launch plan (solve/plane_gs.py::make_plan), built on the host.

The kernel runs one thread-block cluster per sweep; the plan cuts the 2D
rows into one contiguous range per block, balanced by pairs, codes each
pair's column as (owner block, row within it), and sizes the threads and
the shared memory of a block.  These tests need no JAX and no card: the
plan is numpy, and on the CPU the operand runs the plain version.

Cases: both smoothed V-cycle levels of the CHANNEL problem (tests/
parity_fixtures.py, lc=0.12, built by the port on the CPU) and synthetic
row-sorted pair lists of the lc=0.04 channel's shapes (E, Lp, n2d)
(5,037, 77, 749), (1,471, 39, 225), (451, 20, 75).
"""

import numpy as np
import pytest
import torch

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
    matrix_values_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
    _setup_layered, generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
    solve_inlet_profiles)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import plane_gs
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.mg import (
    galerkin_levels)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
    make_annulus_image)

from parity_fixtures import CHANNEL

LC004_SHAPES = [(5037, 77, 749), (1471, 39, 225), (451, 20, 75)]
CASES = ["channel0", "channel1"] + [
    f"lc0.04_{n2d}" for _, _, n2d in LC004_SHAPES]
# (value, iterate) element sizes: (f64, f64), (bf16, f32), (f32, f32)
SIZES = [(8, 8), (2, 4), (4, 4)]


def synthetic_pairs(E: int, n2d: int, seed: int = 0):
    """A row-sorted pair list of n2d rows and E pairs: every row has its
    self-pair and at least one pair, the others couple rows within 25 of
    it (a 2D mesh's band)."""
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(E - n2d, np.full(n2d, 1.0 / n2d)) + 1
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    rows = np.repeat(np.arange(n2d), counts)
    cols = np.clip(rows + rng.integers(-25, 26, E), 0, n2d - 1)
    cols[row_ptr[:-1]] = np.arange(n2d)
    cols = cols[np.lexsort((cols, rows))]
    return row_ptr, cols


@pytest.fixture(scope="module")
def channel_levels(tmp_path_factory):
    """The CHANNEL problem's V-cycle levels on the CPU (the NS Jacobian
    at a seeded state, f64 values)."""
    img = make_annulus_image(
        str(tmp_path_factory.mktemp("k2plan") / "circle.png"),
        CHANNEL["shape"])
    inlet1, inlet2 = solve_inlet_profiles(img, CHANNEL["ratio"], DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, CHANNEL["lc"], DEFAULT)
    st = _setup_layered(mesh, inlet1, inlet2, torch.float64, 3, "cpu")
    lp, a = st.lp, st.lp.arrays
    w = torch.as_tensor(np.random.default_rng(3).normal(size=lp.ndofs) * 0.1)
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / CHANNEL["Re"])
    vals = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, a, w)
    return galerkin_levels(st.mg, vals, a.cols, a.row_ids, a.row_ptr,
                           a.diag_pos, st.mask, lp.n2d, lp.n_planes)


@pytest.fixture
def pairs(request, channel_levels):
    """(row_ptr, cols) of the case named by the test's parameter."""
    name = request.param
    if name.startswith("channel"):
        op = channel_levels[int(name[-1])]
        return op.row_ptr.numpy(), op.cols.numpy()
    E, _, n2d = next(s for s in LC004_SHAPES if name.endswith(f"_{s[2]}"))
    return synthetic_pairs(E, n2d)


@pytest.mark.parametrize("cluster", plane_gs.CLUSTER_SIZES)
@pytest.mark.parametrize("pairs", CASES, indirect=True)
def test_partition_gives_every_row_one_block(pairs, cluster):
    """Every row lies in exactly one block; each block's pair range is
    contiguous and is its rows' pairs; each column code names the block
    that owns the column and its row there."""
    row_ptr, cols = pairs
    n2d = len(row_ptr) - 1
    blocks = plane_gs.partition(row_ptr, cluster)
    assert blocks.shape == (cluster, 4) and blocks.dtype == np.int32
    row0, row1, pair0, pair1 = blocks.T.astype(np.int64)
    assert row0[0] == 0 and row1[-1] == n2d
    assert np.array_equal(row1[:-1], row0[1:]) and np.all(row1 >= row0)
    owner_of_row = np.repeat(np.arange(cluster), row1 - row0)
    assert len(owner_of_row) == n2d
    assert np.array_equal(pair0, row_ptr[row0])
    assert np.array_equal(pair1, row_ptr[row1])
    assert np.array_equal(pair1[:-1], pair0[1:]) and pair1[-1] == row_ptr[-1]
    if cluster <= n2d:           # the cut balances pairs: no empty block
        assert np.all(row1 > row0)
    code = plane_gs.column_codes(blocks, cols).astype(np.int64)
    owner, local = code & 15, code >> 4
    assert np.array_equal(owner, owner_of_row[cols])
    assert np.array_equal(row0[owner] + local, cols)


@pytest.mark.parametrize("vsize, asize", SIZES)
@pytest.mark.parametrize("pairs", CASES, indirect=True)
def test_automatic_plan_fits_a_block(pairs, vsize, asize):
    """The chosen cluster is one of 1..16, its blocks' shared memory is
    within what a block may take and is the layout's total, and its
    threads cover a stage in one pass where 512 threads can."""
    row_ptr, cols = pairs
    plan = plane_gs.make_plan(row_ptr, cols, vsize, asize)
    assert plan.cluster in plane_gs.CLUSTER_SIZES
    assert 1 <= plan.cluster <= 16
    assert plan.smem_bytes <= 232_448
    assert plan.smem_bytes == plane_gs.smem_bytes(
        plan.max_rows, plan.max_pairs, plan.slots, vsize, asize)
    assert plan.slots in (0, 2, 3, 4) and plan.split in (1, 2, 4)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.threads >= min(512, 4 * plan.max_rows * plan.split)
    assert plan.split == 1 or 4 * plan.max_rows * plan.split <= 512
    blocks = plane_gs.partition(row_ptr, plan.cluster)
    assert np.array_equal(plan.blocks, blocks)
    assert plan.max_rows == (blocks[:, 1] - blocks[:, 0]).max()
    assert plan.max_pairs == (blocks[:, 3] - blocks[:, 2]).max()
    # the largest cluster that stages a value ring is taken
    assert plan.staged
    for C in plane_gs.CLUSTER_SIZES:
        if C > plan.cluster:
            try:
                larger = plane_gs.make_plan(row_ptr, cols, vsize, asize, C)
            except ValueError:
                continue
            assert not larger.staged


def test_level0_of_the_lc004_channel_stages_its_values():
    """At level 0 of the lc=0.04 channel both type pairs run a cluster of
    more than one block with the value ring in shared memory."""
    row_ptr, cols = synthetic_pairs(*LC004_SHAPES[0][::2])
    for vsize, asize in SIZES:
        plan = plane_gs.make_plan(row_ptr, cols, vsize, asize)
        assert plan.cluster > 1 and plan.staged and plan.slots >= 2


def test_values_too_large_for_the_ring_are_read_from_memory():
    """A level whose value slices do not fit a ring even at 16 blocks reads
    them from device memory (slots = 0) at the largest cluster; one whose
    iterate does not fit raises."""
    row_ptr, cols = synthetic_pairs(8 * 4000, 4000)
    plan = plane_gs.make_plan(row_ptr, cols, 8, 8)
    assert plan.slots == 0 and not plan.staged and plan.cluster == 16
    with pytest.raises(ValueError, match="do not fit"):
        plane_gs.make_plan(row_ptr, cols, 8, 8, cluster=1)
    row_ptr, cols = synthetic_pairs(2 * 40000, 40000)
    with pytest.raises(ValueError, match="do not fit"):
        plane_gs.make_plan(row_ptr, cols, 8, 8)


def test_schedulable_rules_out_cluster_sizes():
    """The card's occupancy query decides between the sizes that fit; a
    given size that cannot be scheduled raises, as does an unknown
    size."""
    row_ptr, cols = synthetic_pairs(451, 75)
    assert plane_gs.make_plan(row_ptr, cols, 8, 8).cluster == 16
    plan = plane_gs.make_plan(row_ptr, cols, 8, 8,
                              schedulable=lambda p: p.cluster <= 4)
    assert plan.cluster == 4 and plan.staged
    with pytest.raises(RuntimeError, match="can be scheduled"):
        plane_gs.make_plan(row_ptr, cols, 8, 8, cluster=16,
                           schedulable=lambda p: p.cluster < 16)
    with pytest.raises(RuntimeError, match="can be scheduled"):
        plane_gs.make_plan(row_ptr, cols, 8, 8, schedulable=lambda p: False)
    with pytest.raises(ValueError, match="cluster must be"):
        plane_gs.make_plan(row_ptr, cols, 8, 8, cluster=3)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_operand_takes_the_cluster_keyword(channel_levels, dtype):
    """``PlaneGSOperand(cluster=C)`` plans C blocks (here on the CPU, where
    nothing launches), the automatic plan is the default, and a size
    outside 1, 2, 4, 8, 16 is refused.  (Whether each size computes the
    sweep is held against the plain version on the card.)"""
    op = channel_levels[0]
    args = (op.values, op.cols, op.row_ptr, op.diag_pos, op.mask, op.n2d)
    auto = plane_gs.PlaneGSOperand(*args, dtype=dtype)
    chosen = plane_gs.make_plan(op.row_ptr.numpy(), op.cols.numpy(),
                                auto.values.element_size(),
                                auto.mask.element_size())
    assert (auto.plan.cluster, auto.plan.slots, auto.plan.split) \
        == (chosen.cluster, chosen.slots, chosen.split)
    assert np.array_equal(auto.plan.colcode, chosen.colcode)
    for C in (2, 16):
        K = plane_gs.PlaneGSOperand(*args, dtype=dtype, cluster=C)
        assert K.plan.cluster == C and K.stages == 2 * op.n_planes * 3
        assert np.array_equal(K.plan.colcode, plane_gs.column_codes(
            K.plan.blocks, op.cols.numpy()))
    with pytest.raises(ValueError, match="cluster must be"):
        plane_gs.PlaneGSOperand(*args, dtype=dtype, cluster=12).plan
