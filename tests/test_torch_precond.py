"""The port's layered preconditioners against the JAX package's.

CHANNEL mesh (tests/parity_fixtures.py), the Navier-Stokes Jacobian at
the stored CHANNEL solution (tests/fixtures/channel_ns.npz, Re=10), one
apply of each preconditioner on an r seeded with numpy; the JAX closures
run jitted on the CPU.  On the CPU the port's plane-GS sweep is the plain
version of kernel K2 (solve/plane_gs.py).  Tolerances (relative L2):

* f64: 1e-10, only the summation order differs;
* bf16 values: 2e-2.  The JAX package rounds the bf16 relaxations'
  arithmetic to bf16; the port's plane-GS sweep keeps a float32 iterate
  over bf16 values and inverses (the kernel's arithmetic), and its other
  bf16 relaxations round as the JAX package does but sum in another
  order.
"""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble.layered import (  # noqa: E402
    matrix_values_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.solve import (  # noqa: E402
    driver as jax_driver, precond as jax_precond)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    driver, plane_gs, precond)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (  # noqa: E402
    counts)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import (channel_image, jax_channel, port_state,  # noqa: E402
                         rel_l2)

F64, BF16 = 1e-10, 2e-2


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    img = channel_image(tmp_path_factory.mktemp("precond"))
    mesh, W, lp, mask, g, hier = jax_channel(img, mg_levels=0)
    w = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / CHANNEL["Re"])
    vals = np.asarray(matrix_values_layered(
        kern, lp.E, lp.n_planes, lp.bs, lp.arrays, jnp.asarray(w)))
    r = np.random.default_rng(11).standard_normal(W.ndofs)
    arrays, mask_t, _, _ = port_state(lp, mask, g, None)
    return lp, mask, vals, r, arrays, mask_t


def _apply_jax(make, vals, r):
    """``make(values)(r)`` of the JAX package, built and applied in one
    jitted program."""
    return np.asarray(jax.jit(lambda v, b: make(v)(b))(jnp.asarray(vals),
                                                       jnp.asarray(r)))


@pytest.mark.parametrize("pc, tol", [
    ("plane_gs", F64), ("plane_gs_bf16", BF16), ("plane_gs_grouped", F64),
    ("zebra", F64), ("zebra_bf16", BF16), ("line_cr", F64),
    ("line_cr_bf16", BF16), ("bjacobi", F64)])
def test_layered_pc_matches_jax(case, pc, tol):
    """Every non-multigrid name of the JAX package's ``_layered_pc``."""
    lp, mask, vals, r, arrays, mask_t = case
    x_ref = _apply_jax(jax_driver._layered_pc(
        pc, lp.arrays, lp.n2d, lp.n_planes, mask), vals, r)
    x = driver._layered_pc(pc, arrays, lp.n2d, lp.n_planes, mask_t)(
        torch.as_tensor(vals))(torch.as_tensor(r))
    assert x.dtype == torch.float64 and torch.isfinite(x).all()
    assert rel_l2(x, x_ref) <= tol, pc


@pytest.mark.parametrize("pc_dtype, tol", [(None, F64), ("bf16", BF16)])
def test_plane_gs_one_direction_matches_jax(case, pc_dtype, tol):
    """``plane_gs_layered(symmetric=False)``: the downstream sweep alone
    (the symmetric sweep is ``plane_gs[_bf16]`` above)."""
    lp, mask, vals, r, arrays, mask_t = case
    a = lp.arrays
    x_ref = _apply_jax(lambda v: jax_precond.plane_gs_layered(
        v, a.cols, a.row_ids, a.diag_pos, mask, lp.n2d, lp.n_planes,
        symmetric=False, pc_dtype=pc_dtype and jnp.bfloat16), vals, r)
    op = precond.plane_gs_layered(
        torch.as_tensor(vals), arrays.cols, arrays.row_ids,
        arrays.diag_pos, mask_t, lp.n2d, lp.n_planes, symmetric=False,
        pc_dtype=pc_dtype and torch.bfloat16)
    assert isinstance(op, plane_gs.PlaneGSOperand)
    x = op(torch.as_tensor(r))
    assert rel_l2(x, x_ref) <= tol


def test_line_jacobi_matches_jax(case):
    lp, mask, vals, r, arrays, mask_t = case
    x_ref = _apply_jax(lambda v: jax_precond.line_jacobi_layered(
        v, lp.arrays.diag_pos, mask, lp.n2d, lp.n_planes), vals, r)
    x = precond.line_jacobi_layered(
        torch.as_tensor(vals), arrays.diag_pos, mask_t, lp.n2d,
        lp.n_planes)(torch.as_tensor(r))
    assert rel_l2(x, x_ref) <= F64


def test_line_cr_matches_thomas(case):
    """Cyclic reduction solves the same block-tridiagonal columns as the
    blocked Thomas solve (tests/test_mg.py::test_line_cr_matches_thomas)."""
    lp, mask, vals, r, arrays, mask_t = case
    args = (torch.as_tensor(vals), arrays.diag_pos, mask_t, lp.n2d,
            lp.n_planes)
    rt = torch.as_tensor(r)
    x_cr = precond.line_cr_layered(*args)(rt)
    x_th = precond.line_jacobi_layered(*args)(rt)
    assert rel_l2(x_cr, x_th) < 1e-12


def test_plane_gs_operand_checks_its_inputs(case):
    lp, mask, vals, r, arrays, mask_t = case
    V = torch.as_tensor(vals)
    args = (arrays.cols, arrays.row_ptr, arrays.diag_pos, mask_t, lp.n2d)
    with pytest.raises(ValueError, match="values must be"):
        plane_gs.PlaneGSOperand(V[:3], *args)
    with pytest.raises(TypeError, match="unsupported values dtype"):
        plane_gs.PlaneGSOperand(V, *args, dtype=torch.float16)
    with pytest.raises(TypeError, match="int64"):
        plane_gs.PlaneGSOperand(V, arrays.cols.int(), *args[1:])
    op = plane_gs.PlaneGSOperand(V, *args)
    with pytest.raises(ValueError, match="r must be"):
        op(torch.as_tensor(r)[:-4])


def test_plane_gs_on_the_cpu_launches_nothing(case):
    """A CPU tensor runs the plain version: no kernel, no count."""
    lp, mask, vals, r, arrays, mask_t = case
    before = counts("k2_launch")
    for dt in (None, torch.bfloat16):
        op = plane_gs.PlaneGSOperand(
            torch.as_tensor(vals), arrays.cols, arrays.row_ptr,
            arrays.diag_pos, mask_t, lp.n2d, dtype=dt)
        assert op.adtype == (torch.float64 if dt is None else torch.float32)
        x = op(torch.as_tensor(r))
        assert x.dtype == torch.float64
        assert torch.equal(x, plane_gs.plane_gs_plain(op, torch.as_tensor(r)))
    assert counts("k2_launch", before) == {}


def test_newton_plane_gs_matches_jax(case):
    """``solve_newton_layered(..., "plane_gs")`` on the masked system of
    tests/test_layered.py::test_stepped_newton_matches_monolithic (a
    seeded 0/1 mask, BC values on the constrained dofs, nu = 0.5), on the
    CHANNEL operator: converged, within rel-L2 1e-6 of the JAX solve."""
    from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (
        make_ns_sups_kernel as jax_ns_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel as port_ns_kernel)

    lp, _, _, _, arrays, _ = case
    rng = np.random.default_rng(7)
    mask = (rng.uniform(size=lp.ndofs) > 0.2).astype(np.float64)
    g = rng.normal(size=lp.ndofs) * 0.05 * (1.0 - mask)
    args = (lp.n2d, lp.n_planes, lp.bs)
    tols = (1e-10, 0.0, 8, 1e-8, 50, 40, "plane_gs")
    ref = jax_driver.solve_newton_layered(
        jax_ns_kernel("tetrahedron", nu=0.5), *args, lp.arrays,
        jnp.asarray(mask), jnp.asarray(g), jnp.asarray(g), lp.E, *tols)
    out = driver.solve_newton_layered(
        port_ns_kernel("tetrahedron", 0.5), *args, arrays,
        torch.as_tensor(mask), torch.as_tensor(g), torch.as_tensor(g),
        lp.E, *tols)
    assert bool(ref.converged) and out.converged
    assert out.iters == int(ref.iters)
    assert rel_l2(out.x, ref.x) < 1e-6
