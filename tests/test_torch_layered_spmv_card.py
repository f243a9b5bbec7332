"""K1 on the card: the CUDA kernel against its plain version on every
V-cycle level of the CHANNEL problem and of the DFG 3D pillar problem.

This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_layered_spmv_card.py

(``--noconftest``: tests/conftest.py configures JAX).  Without a card
every test skips.  The problem is built by the port alone: the CHANNEL
mesh (lc=0.12), the Navier-Stokes Jacobian at a seeded state and the
Galerkin values of each multigrid level (solve/mg.py::galerkin_levels),
at the pair lists the solve hands K1.  Each case runs the prepared
operand (assemble/layered_spmv.py::LayeredOperand), unmasked and with
the level's BC mask fused in.  The pillar meshes (apps/dfg3d.py, scale
2.0 and scale 1.0 with near_growth 0.15) bring a cross-section with a
hole and few planes: Lp = 7 and 13 on the fine level, 4 and 7 below.
bench.py's problem (lc=0.024, tests/torch_bench_refs.py) brings the
widest launch: Lp = 128 on the fine level, so an f64 team of 512
threads, the kernel's most (64, 32 and 16 planes below), at its NS
Jacobian from g.  Tolerances (relative L2):

* f64 values, f64 x: 1e-12 — only the summation order differs;
* bf16 values, f32 or f64 x: 5e-3 — the plain version rounds each
  product to bf16, the kernel takes it in the x dtype;
* f64 values with f32 x, and f32 values with f32 x (the operator of a
  float32 solve): 1e-5 — both sum in float32, in another order.
"""

import numpy as np
import pytest
import torch

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
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (
    counts, dtype_name)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
    make_annulus_image)

import torch_bench_refs as bench_refs
from parity_fixtures import CHANNEL

PAIR_TOLS = [
    (torch.float64, torch.float64, 1e-12),
    (torch.bfloat16, torch.float32, 5e-3),
    (torch.bfloat16, torch.float64, 5e-3),
    (torch.float64, torch.float32, 1e-5),
    (torch.float32, torch.float32, 1e-5),
]


@pytest.fixture(scope="module")
def levels(tmp_path_factory):
    """Every V-cycle level's (values, pairs, n2d) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    dev = torch.device("cuda")
    img = make_annulus_image(
        str(tmp_path_factory.mktemp("k1card") / "circle.png"),
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
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("vdtype, xdtype, tol", PAIR_TOLS)
def test_kernel_matches_plain_on_card(levels, vdtype, xdtype, tol, masked):
    assert len(levels) >= 2       # the fine level and at least one RAP
    _check_levels(levels, vdtype, xdtype, tol, masked)


def _check_levels(levels, vdtype, xdtype, tol, masked):
    rng = np.random.default_rng(5)
    for k, op in enumerate(levels):
        K = layered_spmv.LayeredOperand(
            op.values, op.cols, op.row_ptr, op.n2d,
            mask=op.mask if masked else None, dtype=vdtype)
        x = torch.as_tensor(rng.standard_normal(op.mask.numel()),
                            device=op.values.device).to(xdtype)
        before = counts("k1_launch")
        y = K(x)
        torch.cuda.synchronize()
        assert sum(counts("k1_launch", before).values()) == 1
        # the tracer's shape counter: one launch of this shape
        shape = (K.E, K.Lp, K.n2d, dtype_name(K.values.dtype),
                 dtype_name(xdtype), masked)
        assert counts("k1_launch", before) == {shape: 1}
        y_plain = layered_spmv.layered_matvec_plain(K, x)
        assert sum(counts("k1_launch", before).values()) == 1
        assert y.dtype == xdtype and torch.isfinite(y).all()
        assert _rel_l2(y, y_plain) <= tol, f"level {k}"
        if masked:                # the constrained rows are x itself
            fixed = K.masks[xdtype] == 0
            assert torch.equal(y[fixed], x[fixed]), f"level {k}"


@pytest.fixture(scope="module", params=[(2.0, 0.3), (1.0, 0.15)],
                ids=["scale2.0", "scale1.0_growth0.15"])
def pillar_levels(request):
    """Every V-cycle level of a DFG 3D pillar operator on the card, and
    its planes per level."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import dfg3d

    scale, growth = request.param
    _mesh, _W, lp, mask, g, hier, _obst = dfg3d._fine_setup(
        scale, 1.0, growth, 3, torch.device("cuda"))
    a = lp.arrays
    kern = make_ns_sups_kernel("tetrahedron", nu=dfg3d.NU,
                               transposed_stab=False)
    vals = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, a, g)
    return galerkin_levels(hier, vals, a.cols, a.row_ids, a.row_ptr,
                           a.diag_pos, mask, lp.n2d, lp.n_planes)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("vdtype, xdtype, tol", PAIR_TOLS)
def test_kernel_matches_plain_on_pillar_levels(pillar_levels, vdtype, xdtype,
                                               tol, masked):
    planes = [op.n_planes for op in pillar_levels]
    assert len(planes) >= 2 and planes[0] in (7, 13) and planes[-1] == 4
    _check_levels(pillar_levels, vdtype, xdtype, tol, masked)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(levels):
    op = levels[0]
    dev = op.values.device
    K = layered_spmv.LayeredOperand(op.values, op.cols, op.row_ptr, op.n2d,
                                    mask=op.mask)
    x = torch.zeros(op.mask.numel(), dtype=torch.float64, device=dev)
    before = counts("k1_launch")
    with pytest.raises(TypeError):
        layered_spmv.LayeredOperand(op.values, op.cols, op.row_ptr, op.n2d,
                                    dtype=torch.float16)
    with pytest.raises(ValueError, match="mask is on cpu"):
        layered_spmv.LayeredOperand(op.values, op.cols, op.row_ptr, op.n2d,
                                    mask=op.mask.cpu())
    with pytest.raises(ValueError, match="cols is on cpu"):
        layered_spmv.LayeredOperand(op.values, op.cols.cpu(), op.row_ptr,
                                    op.n2d)
    with pytest.raises(ValueError, match="x must be"):
        K(x[:-4])
    with pytest.raises(ValueError, match="x must be"):
        K(x.cpu())
    with pytest.raises(ValueError, match="x must be"):
        K(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        K(torch.zeros(2 * x.numel(), dtype=x.dtype, device=dev)[::2])
    assert counts("k1_launch", before) == {}


@pytest.fixture(scope="module")
def bench_levels(tmp_path_factory):
    """Every V-cycle level of bench.py's problem at its NS Jacobian from
    g, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    img = make_annulus_image(
        str(tmp_path_factory.mktemp("k1bench") / "circle.png"), "circle")
    _mesh, st, _ = bench_refs.port_problem(img, torch.device("cuda"))
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / bench_refs.RE)
    return bench_refs.port_levels(st, kern, st.g)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("vdtype, xdtype, tol", PAIR_TOLS)
def test_kernel_matches_plain_at_bench_size(bench_levels, vdtype, xdtype,
                                            tol, masked):
    assert [op.n_planes for op in bench_levels] == [128, 64, 32, 16]
    ppt, _teams = layered_spmv.launch_shape(128, vdtype, xdtype)
    assert 4 * 128 // ppt <= layered_spmv.MAX_TEAM
    _check_levels(bench_levels, vdtype, xdtype, tol, masked)
