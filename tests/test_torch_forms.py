"""Element kernels of the PyTorch port against the JAX package (f64).

The same random non-degenerate tets and states (numpy, seeded) go through
both.  Tolerances (relative L2): 1e-12 against JAX for the residuals and
Jacobians (the same formulas, evaluated in another order), 1e-10 for the
SoA tangent against forward-mode AD of the SoA residual.
"""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble.assembly import (  # noqa: E402
    _cell_jacobians as jax_cell_jacobians)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel as jax_ns_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.stokes import (  # noqa: E402
    make_stokes_kernel as jax_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch import convert  # noqa: E402
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    _cell_jacobians)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes import (  # noqa: E402
    make_stokes_kernel)

from torch_cases import rel_l2  # noqa: E402


def _random_cells(nc, seed):
    rng = np.random.default_rng(seed)
    ref = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    cells = []
    for _ in range(nc):
        A = np.eye(3) + 0.3 * rng.standard_normal((3, 3))
        b = rng.standard_normal(3)
        cells.append(ref @ A.T + b + 0.05 * rng.standard_normal((4, 3)))
    return np.stack(cells), rng.standard_normal((nc, 16))


def _soa(coords, w):
    return coords.transpose(1, 2, 0).reshape(12, -1), w.T.copy()


@pytest.mark.parametrize("transposed", [True, False])
def test_soa_residual_and_jacobian_match_jax(transposed):
    coords, w = _random_cells(37, seed=1)
    kj = jax_ns_kernel("tetrahedron", nu=0.07, transposed_stab=transposed)
    kt = make_ns_sups_kernel(
        "tetrahedron", *convert.kernel_params(kj.params, "cpu"),
        transposed_stab=transposed)
    cT, wT = _soa(coords, w)
    r_ref = kj.res_soa(jnp.asarray(cT), jnp.asarray(wT))
    J_ref = kj.jac_soa(jnp.asarray(cT), jnp.asarray(wT))
    r = kt.res_soa(torch.as_tensor(cT), torch.as_tensor(wT))
    J = kt.jac_soa(torch.as_tensor(cT), torch.as_tensor(wT))
    assert r.shape == (16, 37) and J.shape == (16, 16, 37)
    assert rel_l2(r, r_ref) <= 1e-12
    assert rel_l2(J, J_ref) <= 1e-12


@pytest.mark.parametrize("transposed", [True, False])
def test_soa_jacobian_matches_jacfwd_of_residual(transposed):
    coords, w = _random_cells(11, seed=2)
    kt = make_ns_sups_kernel("tetrahedron", 0.05, 36.0,
                             transposed_stab=transposed)
    cT, wT = (torch.as_tensor(a) for a in _soa(coords, w))
    J = kt.jac_soa(cT, wT)                              # (16, 16, C)
    Jad = torch.func.jacfwd(lambda ww: kt.res_soa(cT, ww))(wT)
    C = wT.shape[1]
    Jad = Jad[:, torch.arange(C), :, torch.arange(C)]    # (C, 16, 16)
    assert rel_l2(J, Jad.permute(1, 2, 0)) <= 1e-10


@pytest.mark.parametrize("transposed", [True, False])
def test_per_cell_ns_kernel_matches_jax(transposed):
    coords, w = _random_cells(23, seed=3)
    kj = jax_ns_kernel("tetrahedron", nu=0.1, transposed_stab=transposed)
    kt = make_ns_sups_kernel("tetrahedron", 0.1,
                             transposed_stab=transposed)
    cj, wj = jnp.asarray(coords), jnp.asarray(w)
    ct, wt = torch.as_tensor(coords), torch.as_tensor(w)
    assert rel_l2(torch.func.vmap(kt)(ct, wt),
                  jax.vmap(kj)(cj, wj)) <= 1e-12
    assert rel_l2(torch.func.vmap(kt.jac)(ct, wt),
                  jax.vmap(kj.jac)(cj, wj)) <= 1e-12


def test_per_cell_stokes_kernel_matches_jax():
    coords, w = _random_cells(23, seed=4)
    kj = jax_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2)
    kt = make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2)
    ct, wt = torch.as_tensor(coords), torch.as_tensor(w)
    assert rel_l2(torch.func.vmap(kt)(ct, wt),
                  jax.vmap(kj)(jnp.asarray(coords), jnp.asarray(w))) <= 1e-12
    # no analytic tangent: jacfwd under vmap on both sides
    dofs = np.arange(23 * 16).reshape(23, 16)
    J_ref = jax_cell_jacobians(kj, jnp.asarray(coords), jnp.asarray(dofs),
                               jnp.asarray(w.reshape(-1)))
    J = _cell_jacobians(kt, ct, torch.as_tensor(dofs),
                        torch.as_tensor(w.reshape(-1)))
    assert rel_l2(J, J_ref) <= 1e-12
