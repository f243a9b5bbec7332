"""FGMRES and the layered Newton driver of the port against the JAX package.

CHANNEL mesh, float64, identical operators and BCs on both sides:

* FGMRES with node-block Jacobi on the Stokes operator: iteration count
  within +-1, solution relative L2 <= 1e-8;
* one Newton step at Re=10 from the JAX package's Stokes solution with
  the main path's Chebyshev V-cycle (bf16 values): the |F| history within
  1e-6 relative, FGMRES iterations within +-1.  The inner solve runs to
  the reference's KSP rtol 1e-8: at the main path's looser 1e-5 the step
  is fixed only to that tolerance, and the bf16 roundings of the two
  smoothers (f32 iterate in the port, f64 in JAX on the CPU) move |F|
  after the step by ~1e-6 relative;
* ||F(w)|| with the BC rows substituted: relative 1e-12.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel as jax_ns_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.stokes import (  # noqa: E402
    make_stokes_kernel as jax_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.solve import (  # noqa: E402
    driver as jax_driver)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes import (  # noqa: E402
    make_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    driver)

from parity_fixtures import CHANNEL  # noqa: E402
from torch_cases import (channel_image, jax_channel, port_state,  # noqa: E402
                         rel_l2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    img = channel_image(tmp_path_factory.mktemp("solve"))
    mesh, W, lp, mask, g, hier = jax_channel(img)
    return lp, mask, g, hier, port_state(lp, mask, g, hier)


def test_fgmres_block_jacobi_stokes(case):
    lp, mask, g, hier, (arrays, mask_t, g_t, _) = case
    args = (lp.n2d, lp.n_planes, lp.bs)
    ref = jax_driver.solve_linear_layered(
        jax_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2), *args,
        lp.arrays, mask, g, lp.E, 1e-8, 50, "bjacobi", None)
    out = driver.solve_linear_layered(
        make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2), *args,
        arrays, mask_t, g_t, lp.E, 1e-8, 50, "bjacobi", None)
    assert bool(ref.converged) and out.converged
    assert abs(out.iters - int(ref.iters)) <= 1, (out.iters, int(ref.iters))
    assert rel_l2(out.x, ref.x) <= 1e-8


def test_one_newton_step(case):
    lp, mask, g, hier, (arrays, mask_t, g_t, hier_t) = case
    args = (lp.n2d, lp.n_planes, lp.bs)
    stokes = jax_driver.solve_linear_layered(
        jax_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2), *args,
        lp.arrays, mask, g, lp.E, 1e-8, 50, "mg", hier)
    w0 = np.asarray(stokes.x)
    nu = 1.0 / CHANNEL["Re"]
    ref = jax_driver.solve_newton_layered(
        jax_ns_kernel("tetrahedron", nu=nu), *args, lp.arrays, mask, g,
        jnp.asarray(w0), lp.E, 0.0, 0.0, 1, 1e-8, 50, 40, "mg_cheby_bf16",
        hier)
    out = driver.solve_newton_layered(
        make_ns_sups_kernel("tetrahedron", nu), *args, arrays, mask_t, g_t,
        torch.tensor(w0), lp.E, 0.0, 0.0, 1, 1e-8, 50, 40,
        "mg_cheby_bf16", hier_t)
    h_ref = np.asarray(ref.history)[:1]
    assert out.iters == int(ref.iters) == 1 and not out.stalled
    assert out.history.shape == (1, 4)
    assert abs(out.history[0, 0] - h_ref[0, 0]) <= 1e-6 * h_ref[0, 0]
    assert out.history[0, 1] == h_ref[0, 1]                  # lambda
    assert abs(out.history[0, 2] - h_ref[0, 2]) <= 1         # FGMRES its
    assert abs(out.resnorm - float(ref.resnorm)) <= 1e-6 * float(ref.resnorm)


def test_residual_norm_layered(case):
    lp, mask, g, hier, (arrays, mask_t, g_t, _) = case
    w = np.random.default_rng(5).normal(size=lp.ndofs) * 0.1
    nu = 1.0 / CHANNEL["Re"]
    ref = float(jax_driver.residual_norm_layered(
        jax_ns_kernel("tetrahedron", nu=nu), lp.n2d, lp.n_planes, lp.bs,
        lp.arrays, mask, g, jnp.asarray(w), lp.E))
    out = driver.residual_norm_layered(
        make_ns_sups_kernel("tetrahedron", nu), lp.n2d, lp.n_planes, lp.bs,
        arrays, mask_t, g_t, torch.as_tensor(w), lp.E)
    assert abs(out - ref) <= 1e-12 * ref
