"""K1 on the card: the CUDA kernel against its plain version on every
V-cycle level of the CHANNEL problem.

This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_layered_spmv_card.py

(``--noconftest``: tests/conftest.py configures JAX).  Without a card
every test skips.  The problem is built by the port alone: the CHANNEL
mesh (lc=0.12), the Navier-Stokes Jacobian at a seeded state and the
Galerkin values of each multigrid level (solve/mg.py::galerkin_levels),
at the pair lists the solve hands K1.  Tolerances (relative L2):

* f64 values, f64 x: 1e-12 — only the summation order differs;
* bf16 values, f32 or f64 x: 5e-3 — the plain version rounds each
  product to bf16, the kernel takes it in the x dtype.
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
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
    make_annulus_image)

from parity_fixtures import CHANNEL


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
@pytest.mark.parametrize("vdtype, xdtype, tol", [
    (torch.float64, torch.float64, 1e-12),
    (torch.bfloat16, torch.float32, 5e-3),
    (torch.bfloat16, torch.float64, 5e-3),
])
def test_kernel_matches_plain_on_card(levels, vdtype, xdtype, tol):
    assert len(levels) >= 2       # the fine level and at least one RAP
    rng = np.random.default_rng(5)
    for k, op in enumerate(levels):
        v = op.values.to(vdtype).contiguous()
        x = torch.as_tensor(rng.standard_normal(op.mask.numel()),
                            device=v.device).to(xdtype)
        before = layered_spmv.LAUNCHES
        y = layered_spmv.layered_matvec_cuda(v, x, op.cols, op.row_ptr,
                                             op.n2d)
        torch.cuda.synchronize()
        assert layered_spmv.LAUNCHES == before + 1
        y_plain = layered_spmv.layered_matvec_plain(v, x, op.cols,
                                                    op.row_ids, op.n2d)
        assert y.dtype == xdtype and torch.isfinite(y).all()
        assert _rel_l2(y, y_plain) <= tol, f"level {k}"


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(levels):
    op = levels[0]
    x = torch.zeros(op.mask.numel(), dtype=torch.float64,
                    device=op.values.device)
    with pytest.raises(TypeError):
        layered_spmv.layered_matvec_cuda(op.values.half(), x, op.cols,
                                         op.row_ptr, op.n2d)
    with pytest.raises(ValueError, match="x must be"):
        layered_spmv.layered_matvec_cuda(op.values, x[:-4], op.cols,
                                         op.row_ptr, op.n2d)
    with pytest.raises(ValueError, match="contiguous"):
        layered_spmv.layered_matvec_cuda(
            op.values.transpose(3, 4).contiguous().transpose(3, 4), x,
            op.cols, op.row_ptr, op.n2d)
