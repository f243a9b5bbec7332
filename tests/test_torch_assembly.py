"""Structured/layered assembly of the PyTorch port against the JAX package.

CHANNEL mesh (lc=0.12), the same seeded state on both sides, float64.
Tolerance: relative L2 1e-12 (the same sums in another order).
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import (  # noqa: E402
    structured as jax_structured)
from stabilized_navier_stokes_flow_fenicsx_tpu.assemble.assembly import (  # noqa: E402
    AsmArrays, residual_of as jax_residual_of)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel as jax_ns_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.stokes import (  # noqa: E402
    make_stokes_kernel as jax_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (  # noqa: E402
    structured)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    residual_of)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes import (  # noqa: E402
    make_stokes_kernel)

from torch_cases import (channel_image, jax_channel, port_state,  # noqa: E402
                         rel_l2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    img = channel_image(tmp_path_factory.mktemp("asm"))
    mesh, W, lp, mask, g, hier = jax_channel(img, mg_levels=0)
    arrays, _, _, _ = port_state(lp, mask, g, hier)
    w = np.random.default_rng(7).normal(size=W.ndofs) * 0.1
    return lp, arrays, w


def _kernels(kind):
    if kind == "ns":
        return (jax_ns_kernel("tetrahedron", nu=0.1),
                make_ns_sups_kernel("tetrahedron", 0.1))
    return (jax_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2),
            make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2))


def test_residual_structured(case):
    lp, arrays, w = case
    kj, kt = _kernels("ns")
    r_ref = jax_structured.residual_structured(
        kj, lp.n_planes, lp.arrays.sasm, jnp.asarray(w))
    r = structured.residual_structured(kt, lp.n_planes, arrays.sasm,
                                       torch.as_tensor(w))
    assert rel_l2(r, r_ref) <= 1e-12


def test_matrix_values_structured_soa(case):
    lp, arrays, w = case
    kj, kt = _kernels("ns")
    V_ref = jax_structured.matrix_values_structured_soa(
        kj, lp.E, lp.n_planes, lp.bs, lp.arrays.sasm, jnp.asarray(w))
    V = structured.matrix_values_structured_soa(
        kt, lp.E, lp.n_planes, lp.bs, arrays.sasm, torch.as_tensor(w))
    assert V.shape == (4, 4, 3, lp.E, lp.n_planes) and V.is_contiguous()
    assert rel_l2(V, V_ref) <= 1e-12


def test_matrix_values_structured_aos_stokes(case):
    """The Stokes kernel has no SoA variant: per-cell jacfwd Jacobians
    through the same layer-minor buffer."""
    lp, arrays, w = case
    kj, kt = _kernels("stokes")
    V_ref = jax_structured.matrix_values_structured(
        kj, lp.E, lp.n_planes, lp.bs, lp.arrays.sasm, jnp.asarray(w))
    V = structured.matrix_values_structured(
        kt, lp.E, lp.n_planes, lp.bs, arrays.sasm, torch.as_tensor(w))
    assert rel_l2(V, V_ref) <= 1e-12


def test_residual_of_stokes(case):
    lp, arrays, w = case
    kj, kt = _kernels("stokes")
    a = lp.arrays
    asm = AsmArrays(cell_dofs=a.cell_dofs, cell_coords=a.cell_coords,
                    indices=a.cols, row_ids=a.row_ids, ell_pos=a.ell_pos,
                    diag_pos=a.diag_pos)
    r_ref = jax_residual_of(kj, lp.ndofs, asm, jnp.asarray(w))
    r = residual_of(kt, lp.ndofs, arrays, torch.as_tensor(w))
    assert rel_l2(r, r_ref) <= 1e-12
