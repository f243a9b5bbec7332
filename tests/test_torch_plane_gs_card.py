"""K2 on the card: the plane-GS sweep kernel against its plain version on
every V-cycle level of the CHANNEL problem.

This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_plane_gs_card.py

(``--noconftest``: tests/conftest.py configures JAX).  Without a card
every test skips.  The problem is built by the port alone: the CHANNEL
mesh (lc=0.12), the Navier-Stokes Jacobian at a seeded state and the
Galerkin values of each multigrid level (solve/mg.py::galerkin_levels).
Each case runs the prepared operand (solve/plane_gs.py::PlaneGSOperand)
with the sweep's options: symmetric or downstream only, and 0 to 3
inner passes (an odd count ends in the kernel's second buffer); then
the kernel's thread-block cluster at every size of 1, 2, 4, 8 and 16
that the card can schedule, on level 0, and its edge cases: rows that
the cluster size does not divide, fewer rows than blocks, one plane, a
mask with random zeros, and a level whose value slices do not fit
shared memory (read from device memory instead).  Last, level 0 of
bench.py's problem (lc=0.024, tests/torch_bench_refs.py: 173 rows a
block, so a stage takes two passes of the 512 threads) at its NS
Jacobian from g, in each pair at the plan the card takes: the values
read from device memory in (f64, f64), a ring of 4 slices in (bf16,
f32) and of 3 (223,648 bytes a block) in (f32, f32).  Tolerances (relative
L2): 1e-10 with f64 values, 1e-4 with bf16 or f32 values and the f32
iterate: both sides compute in the iterate's type and differ in the
summation order of the 2D products, which the sweep carries from plane
to plane.
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
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (
    counts, dtype_name)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
    make_annulus_image)

import torch_bench_refs as bench_refs
from parity_fixtures import CHANNEL

PAIR_TOLS = [(torch.float64, torch.float64, 1e-10),
             (torch.bfloat16, torch.float32, 1e-4)]
F32_TOL = (torch.float32, torch.float32, 1e-4)


@pytest.fixture(scope="module")
def levels(tmp_path_factory):
    """Every V-cycle level's (values, pairs, n2d) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    dev = torch.device("cuda")
    img = make_annulus_image(
        str(tmp_path_factory.mktemp("k2card") / "circle.png"),
        CHANNEL["shape"])
    inlet1, inlet2 = solve_inlet_profiles(img, CHANNEL["ratio"], DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, CHANNEL["lc"], DEFAULT)
    st = _setup_layered(mesh, inlet1, inlet2, torch.float64, 3, dev)
    lp, a = st.lp, st.lp.arrays
    w = torch.as_tensor(
        np.random.default_rng(3).normal(size=lp.ndofs) * 0.1, device=dev)
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / CHANNEL["Re"])
    vals = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, a, w)
    return galerkin_levels(st.mg, vals, a.cols, a.row_ids, a.row_ptr,
                           a.diag_pos, st.mask, lp.n2d, lp.n_planes)


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("inner_sweeps", [0, 1, 2, 3])
@pytest.mark.parametrize("symmetric", [True, False],
                         ids=["symmetric", "downstream"])
@pytest.mark.parametrize("vdtype, adtype, tol", PAIR_TOLS)
def test_kernel_matches_plain_on_card(levels, vdtype, adtype, tol,
                                      symmetric, inner_sweeps):
    assert len(levels) >= 2
    rng = np.random.default_rng(5)
    for k, op in enumerate(levels):
        K = plane_gs.PlaneGSOperand(
            op.values, op.cols, op.row_ptr, op.diag_pos, op.mask, op.n2d,
            inner_sweeps=inner_sweeps, symmetric=symmetric, dtype=vdtype)
        assert K.adtype == adtype
        r = torch.as_tensor(rng.standard_normal(op.mask.numel()),
                            device=op.values.device)
        before = counts("k2_launch")
        x = K(r)
        torch.cuda.synchronize()
        assert sum(counts("k2_launch", before).values()) == 1
        x_plain = plane_gs.plane_gs_plain(K, r)
        assert sum(counts("k2_launch", before).values()) == 1
        assert x.dtype == r.dtype and torch.isfinite(x).all()
        assert _rel_l2(x, x_plain) <= tol, f"level {k}"


@pytest.mark.cuda
def test_launches_counted_by_type_pair(levels):
    op = levels[0]
    before = counts("k2_launch")
    r = torch.ones(op.mask.numel(), dtype=torch.float64,
                   device=op.values.device)
    for vdtype, adtype, _ in PAIR_TOLS:
        plane_gs.PlaneGSOperand(op.values, op.cols, op.row_ptr, op.diag_pos,
                                op.mask, op.n2d, dtype=vdtype)(r)
    torch.cuda.synchronize()
    launches = counts("k2_launch", before)
    assert sum(launches.values()) == 2
    by_pair = {}            # by a key's (values dtype, iterate dtype)
    for key, n in launches.items():
        by_pair[key[3:5]] = by_pair.get(key[3:5], 0) + n
    assert by_pair == {
        (dtype_name(v), dtype_name(a)): 1 for v, a, _ in PAIR_TOLS}


def _check(K, r, tol, what):
    """One launch of K against the plain version on r."""
    before = counts("k2_launch")
    x = K(r)
    torch.cuda.synchronize()
    assert sum(counts("k2_launch", before).values()) == 1
    # the tracer's shape counter: one launch of this shape
    shape = (K.E, K.Lp, K.n2d, dtype_name(K.vdtype), dtype_name(K.adtype),
             K.inner_sweeps, K.symmetric)
    assert counts("k2_launch", before) == {shape: 1}, what
    x_plain = plane_gs.plane_gs_plain(K, r)
    assert x.dtype == r.dtype and torch.isfinite(x).all(), what
    assert _rel_l2(x, x_plain) <= tol, what


def _operand(*args, **kwargs):
    """The operand, or a skip where the card cannot schedule its
    cluster (the operand raises so; a size that does not fit is a
    failure here)."""
    try:
        return plane_gs.PlaneGSOperand(*args, **kwargs)
    except RuntimeError as e:
        if "can be scheduled" in str(e):
            pytest.skip(str(e))
        raise


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", plane_gs.CLUSTER_SIZES)
@pytest.mark.parametrize("vdtype, adtype, tol", PAIR_TOLS + [F32_TOL])
def test_kernel_matches_plain_at_every_cluster_size(levels, vdtype, adtype,
                                                    tol, cluster):
    op = levels[0]
    K = _operand(op.values, op.cols, op.row_ptr, op.diag_pos, op.mask,
                 op.n2d, dtype=vdtype, cluster=cluster)
    assert K.plan.cluster == cluster and K.adtype == adtype
    r = torch.as_tensor(np.random.default_rng(cluster).standard_normal(
        op.mask.numel()), device=op.values.device)
    _check(K, r, tol, f"cluster {cluster}")


def _synthetic(n2d, Lp, per_row, rng):
    """A diagonally dominant operand on the card: n2d rows of ``per_row``
    pairs coupling rows within 40 of each other, Lp planes, random
    values; (values, cols, row_ptr, diag_pos, mask)."""
    dev = torch.device("cuda")
    row_ptr = np.arange(n2d + 1) * per_row
    rows = np.repeat(np.arange(n2d), per_row)
    cols = np.clip(rows + rng.integers(-40, 41, rows.size), 0, n2d - 1)
    cols[row_ptr[:-1]] = np.arange(n2d)
    cols = cols[np.lexsort((cols, rows))]
    diag = np.array([row_ptr[i] + np.searchsorted(
        cols[row_ptr[i]:row_ptr[i + 1]], i) for i in range(n2d)])
    V = rng.standard_normal((4, 4, 3, rows.size, Lp)) * 0.1
    V[:, :, 1, diag, :] += 4.0 * np.eye(4)[:, :, None, None]
    return (torch.as_tensor(V, device=dev),
            torch.as_tensor(cols, device=dev),
            torch.as_tensor(row_ptr, device=dev),
            torch.as_tensor(diag, device=dev),
            torch.ones(Lp * n2d * 4, dtype=torch.float64, device=dev))


def _lp1_random_mask(op, rng):
    """Level ``op``'s first plane alone, with 30% of its mask zeroed."""
    mask = op.mask.reshape(op.n_planes, -1)[:1].reshape(-1).clone()
    mask[torch.as_tensor(rng.random(mask.numel()) < 0.3,
                         device=mask.device)] = 0
    return op.values[..., :1].contiguous(), mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["not_divisible", "fewer_rows_than_blocks",
                                  "one_plane_random_mask", "random_mask",
                                  "odd_inner_downstream"])
@pytest.mark.parametrize("vdtype, adtype, tol", PAIR_TOLS)
def test_kernel_edge_cases(levels, vdtype, adtype, tol, case):
    rng = np.random.default_rng(11)
    op, kwargs = levels[0], {}
    values, cols, row_ptr, diag, mask, n2d = (
        op.values, op.cols, op.row_ptr, op.diag_pos, op.mask, op.n2d)
    if case == "not_divisible":          # CHANNEL level 1
        op = levels[1]
        values, cols, row_ptr, diag, mask, n2d = (
            op.values, op.cols, op.row_ptr, op.diag_pos, op.mask, op.n2d)
        clusters = [c for c in (2, 4, 8, 16) if n2d % c]
    elif case == "fewer_rows_than_blocks":   # 6 rows, 5 planes
        n2d = 6
        values, cols, row_ptr, diag, mask = _synthetic(n2d, 5, 3, rng)
        clusters = [8, 16]
    elif case == "one_plane_random_mask":
        values, mask = _lp1_random_mask(op, rng)
        clusters = [None, 4]
    elif case == "random_mask":
        mask = op.mask.clone()
        mask[torch.as_tensor(rng.random(mask.numel()) < 0.3,
                             device=mask.device)] = 0
        clusters = [None, 8]
    else:
        kwargs = dict(inner_sweeps=3, symmetric=False)
        clusters = [None, 8, 16]
    assert clusters, case
    ran = 0
    for cluster in clusters:
        try:
            K = plane_gs.PlaneGSOperand(values, cols, row_ptr, diag, mask,
                                        n2d, dtype=vdtype, cluster=cluster,
                                        **kwargs)
        except RuntimeError as e:
            assert "can be scheduled" in str(e)
            continue
        r = torch.as_tensor(rng.standard_normal(mask.numel()),
                            device=values.device)
        _check(K, r, tol, f"{case}, cluster {cluster}")
        ran += 1
    assert ran, f"{case}: no cluster size could be scheduled"


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype, adtype, tol", PAIR_TOLS + [F32_TOL])
def test_kernel_reads_values_from_memory_where_the_ring_does_not_fit(
        vdtype, adtype, tol):
    """2,500 rows (f64 values; 6,000 with narrower values) of 8 pairs on
    3 planes: the value slices fit no ring, so the plan reads them from
    device memory (prefetched into L2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    rng = np.random.default_rng(2)
    n2d = 2500 if vdtype == torch.float64 else 6000
    values, cols, row_ptr, diag, mask = _synthetic(n2d, 3, 8, rng)
    K = plane_gs.PlaneGSOperand(values, cols, row_ptr, diag, mask, n2d,
                                dtype=vdtype)
    assert not K.plan.staged
    r = torch.as_tensor(rng.standard_normal(mask.numel()),
                        device=mask.device)
    _check(K, r, tol, "values from memory")


@pytest.fixture(scope="module")
def bench_level0(tmp_path_factory):
    """Level 0 of bench.py's problem at its NS Jacobian from g, on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    img = make_annulus_image(
        str(tmp_path_factory.mktemp("k2bench") / "circle.png"), "circle")
    _mesh, st, _ = bench_refs.port_problem(img, torch.device("cuda"))
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / bench_refs.RE)
    return bench_refs.port_levels(st, kern, st.g)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype, adtype, tol, slots",
                         [(*PAIR_TOLS[0], 0), (*PAIR_TOLS[1], 4),
                          (*F32_TOL, 3)])
def test_kernel_matches_plain_at_bench_size(bench_level0, vdtype, adtype,
                                            tol, slots):
    op = bench_level0
    assert (op.n_planes, op.n2d) == (128, 2058)
    K = plane_gs.PlaneGSOperand(op.values, op.cols, op.row_ptr, op.diag_pos,
                                op.mask, op.n2d, dtype=vdtype)
    p = K.plan
    assert (p.cluster, p.split, p.threads, p.slots) == (16, 1, 512, slots)
    assert 4 * p.max_rows * p.split > p.threads      # two passes a stage
    r = torch.as_tensor(np.random.default_rng(13).standard_normal(
        op.mask.numel()), device=op.values.device)
    _check(K, r, tol, f"bench level 0, {slots} slots")
