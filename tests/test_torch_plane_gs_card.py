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
inner passes (an odd count ends in the kernel's second buffer).
Tolerances (relative L2): 1e-10 with f64 values, 1e-4 with bf16 values
and the f32 iterate: both sides compute in the iterate's type and differ
in the summation order of the 2D products, which the sweep carries from
plane to plane.
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

PAIR_TOLS = [(torch.float64, torch.float64, 1e-10),
             (torch.bfloat16, torch.float32, 1e-4)]


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
        before = plane_gs.LAUNCHES
        x = K(r)
        torch.cuda.synchronize()
        assert plane_gs.LAUNCHES == before + 1
        x_plain = plane_gs.plane_gs_plain(K, r)
        assert plane_gs.LAUNCHES == before + 1
        assert x.dtype == r.dtype and torch.isfinite(x).all()
        assert _rel_l2(x, x_plain) <= tol, f"level {k}"


@pytest.mark.cuda
def test_launches_counted_by_type_pair(levels):
    op = levels[0]
    plane_gs.reset_launches()
    r = torch.ones(op.mask.numel(), dtype=torch.float64,
                   device=op.values.device)
    for vdtype, adtype, _ in PAIR_TOLS:
        plane_gs.PlaneGSOperand(op.values, op.cols, op.row_ptr, op.diag_pos,
                                op.mask, op.n2d, dtype=vdtype)(r)
    torch.cuda.synchronize()
    assert plane_gs.LAUNCHES == 2
    assert plane_gs.LAUNCHES_BY_DTYPES == {
        (v, a): 1 for v, a, _ in PAIR_TOLS}
