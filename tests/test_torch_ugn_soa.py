"""The port's UGN SoA element kernels (forms/soa.py::make_ugn_soa).

Float64 on the CPU, seeded random tetrahedra and states (the cases of
tests/test_soa.py for ``make_ugn_soa``):

* ``res_soa`` / ``jac_soa`` against the JAX package's on the same
  inputs: relative 1e-12 (atol 1e-13 on values that cancel to zero);
* against the port's own per-cell kernel: the residual under ``vmap``
  and ``torch.func.jacfwd`` of it, relative 1e-10;
* with cells at rest (u = 0 at every vertex), where the |u| <= 1e-8 guard
  of tau_1 holds and ``tiny`` keeps the square root differentiable:
  finite, and equal to JAX's and to ``jacfwd``;
* ``make_ns_ugn_kernel`` attaches the pair on tetrahedra and none on
  triangles.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.forms import (  # noqa: E402
    soa as jax_soa)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms import (  # noqa: E402
    navier_stokes, soa)

torch.set_num_threads(1)

NU = 0.05


def _random_cells(nc, seed, n_rest=0):
    """Non-degenerate random tets (unit reference tet, affine map,
    jitter) and states; the first ``n_rest`` cells have zero velocity."""
    rng = np.random.default_rng(seed)
    ref = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    cells = []
    for _ in range(nc):
        A = np.eye(3) + 0.3 * rng.standard_normal((3, 3))
        b = rng.standard_normal(3)
        cells.append(ref @ A.T + b + 0.05 * rng.standard_normal((4, 3)))
    coords = np.stack(cells)
    w = rng.standard_normal((nc, 16))
    w.reshape(nc, 4, 4)[:n_rest, :, :3] = 0.0
    return coords, w


def _soa_inputs(coords, w):
    return coords.transpose(1, 2, 0).reshape(12, -1), w.T.copy()


@pytest.fixture(scope="module", params=[(23, 2, 0), (9, 5, 3)],
                ids=["moving", "with_cells_at_rest"])
def case(request):
    nc, seed, n_rest = request.param
    coords, w = _random_cells(nc, seed, n_rest)
    cT, wT = _soa_inputs(coords, w)
    res_soa, jac_soa = soa.make_ugn_soa("tetrahedron", 2)
    params = (torch.tensor(NU, dtype=torch.float64),)
    r = res_soa(params, torch.tensor(cT), torch.tensor(wT))
    J = jac_soa(params, torch.tensor(cT), torch.tensor(wT))
    return coords, w, cT, wT, r.numpy(), J.numpy()


def test_ugn_soa_finite_and_shaped(case):
    coords, _w, _cT, _wT, r, J = case
    nc = coords.shape[0]
    assert r.shape == (16, nc) and J.shape == (16, 16, nc)
    assert np.isfinite(r).all() and np.isfinite(J).all()


def test_ugn_soa_against_jax(case):
    _coords, _w, cT, wT, r, J = case
    jres, jjac = jax_soa.make_ugn_soa("tetrahedron", 2)
    r_ref = np.asarray(jres((NU,), jnp.asarray(cT), jnp.asarray(wT)))
    J_ref = np.asarray(jjac((NU,), jnp.asarray(cT), jnp.asarray(wT)))
    np.testing.assert_allclose(r, r_ref, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(J, J_ref, rtol=1e-12, atol=1e-13)


def test_ugn_soa_against_aos_jacfwd(case):
    coords, w, _cT, _wT, r, J = case
    kern = navier_stokes.make_ns_ugn_kernel("tetrahedron", NU)
    ct, wt = torch.tensor(coords), torch.tensor(w)
    r_ref = torch.func.vmap(kern)(ct, wt).numpy()

    def cell_jac(c, we):
        return torch.func.jacfwd(lambda ww: kern(c, ww))(we)

    J_ref = torch.func.vmap(cell_jac)(ct, wt).numpy()
    np.testing.assert_allclose(r.T, r_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(J.transpose(2, 0, 1), J_ref,
                               rtol=1e-10, atol=1e-11)
    # and the hand-derived tangent the block-CSR path assembles
    J_hand = torch.func.vmap(kern.jac)(ct, wt).numpy()
    np.testing.assert_allclose(J.transpose(2, 0, 1), J_hand,
                               rtol=1e-10, atol=1e-11)


def test_ugn_kernel_carries_soa_on_tetrahedra_only():
    k3 = navier_stokes.make_ns_ugn_kernel("tetrahedron", NU)
    k2 = navier_stokes.make_ns_ugn_kernel("triangle", NU)
    assert k3.res_soa is not None and k3.jac_soa is not None
    assert k2.res_soa is None and k2.jac_soa is None
    with pytest.raises(ValueError):
        soa.make_ugn_soa("triangle", 2)
