"""The port's multigrid preconditioners against the JAX package's
``make_mg_pc``, ``parse_mg_pc`` and the ``pc="mg"`` Stokes solve.

CHANNEL mesh, the Navier-Stokes Jacobian at the stored CHANNEL solution
(tests/fixtures/channel_ns.npz, Re=10), one V-cycle apply on a seeded r
(the JAX closures jitted).  The CHANNEL hierarchy has one coarse level,
solved densely; a second hierarchy with min_dofs=200 has three, for the
W-cycle.  Tolerances (relative L2):

* the Chebyshev and Jacobi-family smoothers: 1e-5, since they run in f32
  on both sides (the port also keeps the smoother's mask and matvec in
  f32, where the JAX package takes them in the mask's f64);
* the plane, zebra and line smoothers on f64 values: 1e-5 with the dense
  coarse solve, whose float32 inverse comes from another LAPACK routine
  on each side, and 1e-10 with the coarsest level relaxed (every step in
  f64, only the summation order differs);
* bf16 level values: 2e-2 (the JAX package rounds its bf16 plane sweeps
  to bf16, the port keeps a float32 iterate);
* 1e-5 for the ``_lam_max_tail`` spectral estimates.
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
    driver as jax_driver, mg as jax_mg)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    driver, mg)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import (channel_image, jax_channel, port_state,  # noqa: E402
                         rel_l2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    img = channel_image(tmp_path_factory.mktemp("mg"))
    mesh, W, lp, mask, g, hier = jax_channel(img)
    w = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / CHANNEL["Re"])
    vals = np.asarray(matrix_values_layered(
        kern, lp.E, lp.n_planes, lp.bs, lp.arrays, jnp.asarray(w)))
    r = np.random.default_rng(11).standard_normal(W.ndofs)
    return lp, mask, g, hier, vals, r


def _build(case, pc_dtype):
    lp, mask, g, hier, vals, r = case
    a = lp.arrays
    apply_j = jax_mg.make_mg_pc(
        hier, jnp.asarray(vals), a.cols, a.row_ids, a.diag_pos, mask,
        lp.n2d, lp.n_planes, pc_dtype=pc_dtype and jnp.bfloat16,
        smoother="cheby")
    arrays, mask_t, _, hier_t = port_state(lp, mask, g, hier)
    apply_t = mg.make_mg_pc(
        hier_t, torch.as_tensor(vals), arrays.cols, arrays.row_ids,
        arrays.row_ptr, arrays.diag_pos, mask_t, lp.n2d, lp.n_planes,
        pc_dtype=pc_dtype and torch.bfloat16, smoother="cheby")
    return apply_j, apply_t


@pytest.mark.parametrize("pc_dtype, tol", [(None, 1e-5), ("bf16", 2e-2)])
def test_vcycle_apply_matches_jax(case, pc_dtype, tol):
    r = case[-1]
    apply_j, apply_t = _build(case, pc_dtype)
    x_ref = jax.jit(apply_j)(jnp.asarray(r))
    x = apply_t(torch.as_tensor(r))
    assert x.dtype == torch.float64 and torch.isfinite(x).all()
    assert rel_l2(x, x_ref) <= tol


def test_lam_max_tail_matches_jax(case, monkeypatch):
    """The per-level spectral estimates, recorded as each make_mg_pc
    computes them (the JAX package's estimate is the result of its
    12-step power iteration loop)."""
    seen_j, seen_t = [], []
    fori = jax.lax.fori_loop

    def recording_fori(lo, hi, body, init):
        out = fori(lo, hi, body, init)
        if hi == 12:
            seen_j.append(float(out[1]))
        return out

    lam_t = mg._lam_max_tail

    def recording_lam(*args, **kw):
        out = lam_t(*args, **kw)
        seen_t.append(float(out))
        return out

    monkeypatch.setattr(jax.lax, "fori_loop", recording_fori)
    monkeypatch.setattr(mg, "_lam_max_tail", recording_lam)
    _build(case, None)
    n_levels = len(case[3].levels) + 1
    assert len(seen_j) == len(seen_t) == n_levels
    assert rel_l2(seen_t, seen_j) <= 1e-5


def _pc_pair(case, pc, hier=None):
    """One apply of ``_layered_pc(pc)`` in the JAX package (jitted) and
    the port, on the case's values and r."""
    lp, mask, g, hier0, vals, r = case
    hier = hier0 if hier is None else hier
    arrays, mask_t, _, hier_t = port_state(lp, mask, g, hier)
    make = jax_driver._layered_pc(pc, lp.arrays, lp.n2d, lp.n_planes, mask,
                                  hier)
    x_ref = jax.jit(lambda v, b: make(v)(b))(jnp.asarray(vals),
                                             jnp.asarray(r))
    x = driver._layered_pc(pc, arrays, lp.n2d, lp.n_planes, mask_t, hier_t)(
        torch.as_tensor(vals))(torch.as_tensor(r))
    assert x.dtype == torch.float64 and torch.isfinite(x).all()
    return x, x_ref


@pytest.mark.parametrize("pc, tol", [
    ("mg", 1e-5), ("mg_bf16", 2e-2), ("mg_jacobi", 1e-5),
    ("mg_zebra", 1e-5), ("mg_grouped", 1e-5), ("mg_line", 1e-5),
    ("mg_lined", 1e-5), ("mg_linej", 1e-5), ("mg_cheby4", 1e-5)])
def test_mg_smoother_matches_jax(case, pc, tol):
    """``make_mg_pc`` with each smoother of the JAX package, by its PC
    name, the dense coarse solve on the CHANNEL hierarchy."""
    x, x_ref = _pc_pair(case, pc)
    assert rel_l2(x, x_ref) <= tol, pc


@pytest.fixture(scope="module")
def deep_hierarchy(case):
    """The CHANNEL operator coarsened three times (min_dofs=200)."""
    lp, mask = case[0], case[1]
    return jax_mg.build_mg_hierarchy(
        np.asarray(lp.pattern_like.row_ids),
        np.asarray(lp.pattern_like.indices), lp.n2d, lp.n_planes,
        np.asarray(mask, np.float32), lp.bs, n_levels=3, min_dofs=200)


@pytest.mark.parametrize("pc, tol", [("mgw", 1e-5),
                                     ("mg_chebyw_bf16", 2e-2)])
def test_w_cycle_matches_jax(case, deep_hierarchy, pc, tol):
    assert len(deep_hierarchy.levels) == 3
    x, x_ref = _pc_pair(case, pc, deep_hierarchy)
    assert rel_l2(x, x_ref) <= tol, pc


@pytest.mark.parametrize("pc", ["mg", "mg_jacobi", "mg_chebyw_bf16",
                                "plane_gs"])
def test_other_smoothers_are_refused(case, pc):
    """A plane-sharded level 0 (``fine=``) takes the Chebyshev V-cycle
    only, as the JAX package's sharded path: every other smoother and the
    W-cycle are refused before anything is built."""
    lp, mask, g, hier, vals, _ = case
    arrays, mask_t, _, hier_t = port_state(lp, mask, g, hier)
    parsed = driver.parse_mg_pc(pc)
    sm, cyc = (parsed[0], parsed[2]) if parsed else (pc, "v")
    fine = mg.SlabFine(operand=None, project=None, reduce=None)
    with pytest.raises(ValueError, match="plane-sharded"):
        mg.make_mg_pc(hier_t, torch.as_tensor(vals), arrays.cols,
                      arrays.row_ids, arrays.row_ptr, arrays.diag_pos,
                      mask_t, lp.n2d, lp.n_planes, smoother=sm,
                      cycle_type=cyc, fine=fine)


@pytest.mark.parametrize("pc, parsed", [
    ("mg_cheby_bf16", ("cheby", 6, "v", "bf16")),
    ("mg_cheby4_bf16", ("cheby", 4, "v", "bf16")),
    ("mg_cheby", ("cheby", 6, "v", None)),
    ("mg_cheby_bf32", None),
    ("jacobi", None),
    ("mg", ("plane_gs", 6, "v", None)),
    ("mg_bf16", ("plane_gs", 6, "v", "bf16")),
    ("mgw", ("plane_gs", 6, "w", None)),
    ("mg_jacobi", ("jacobi", 6, "v", None)),
    ("mg_zebra", ("zebra", 6, "v", None)),
    ("mg_grouped", ("grouped", 6, "v", None)),
    ("mg_line", ("line", 6, "v", None)),
    ("mg_lined", ("lined", 6, "v", None)),
    ("mg_linej", ("linej", 6, "v", None)),
    ("mg_chebyw_bf16", ("cheby", 6, "w", "bf16")),
    ("mg_cheby6w", ("cheby", 6, "w", None)),
    ("plane_gs", None),
    ("mg_gauss", None),
])
def test_parse_mg_pc(pc, parsed):
    """The port's grammar is the JAX package's: the same tuple, with
    torch.bfloat16 for jnp.bfloat16."""
    def norm(p, bf16):
        return None if p is None else p[:3] + ("bf16" if p[3] == bf16
                                               else p[3],)

    assert norm(driver.parse_mg_pc(pc), torch.bfloat16) == parsed
    assert norm(jax_driver.parse_mg_pc(pc), jnp.bfloat16) == parsed


def test_coarsest_level_above_dense_cap_is_refused(case):
    """Above ``dense_cap`` the dense coarse solve is refused: the coarsest
    level is relaxed with its smoother ``n_coarse_sweeps`` times, as the
    JAX package does; every step is then f64 in the plane-GS V-cycle."""
    lp, mask, g, hier, vals, r = case
    n2d_c, Lp_c, _ = hier.dims[-1]
    cap = n2d_c * Lp_c * lp.bs - 1
    a = lp.arrays
    x_ref = jax.jit(jax_mg.make_mg_pc(
        hier, jnp.asarray(vals), a.cols, a.row_ids, a.diag_pos, mask,
        lp.n2d, lp.n_planes, dense_cap=cap))(jnp.asarray(r))
    arrays, mask_t, _, hier_t = port_state(lp, mask, g, hier)
    args = (hier_t, torch.as_tensor(vals), arrays.cols, arrays.row_ids,
            arrays.row_ptr, arrays.diag_pos, mask_t, lp.n2d, lp.n_planes)
    x = mg.make_mg_pc(*args, dense_cap=cap)(torch.as_tensor(r))
    assert rel_l2(x, x_ref) <= 1e-10
    x_dense = mg.make_mg_pc(*args)(torch.as_tensor(r))
    assert rel_l2(x_dense, x) > 1e-3


def test_stokes_mg_matches_jax(case):
    """``solve_linear_layered(..., pc="mg")`` on the CHANNEL Stokes form:
    the FGMRES count within 1 of the JAX package's, rel-L2 < 1e-8."""
    from stabilized_navier_stokes_flow_fenicsx_tpu.forms.stokes import (
        make_stokes_kernel as jax_stokes_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes import (
        make_stokes_kernel)

    lp, mask, g, hier, _, _ = case
    arrays, mask_t, g_t, hier_t = port_state(lp, mask, g, hier)
    args = (lp.n2d, lp.n_planes, lp.bs)
    ref = jax_driver.solve_linear_layered(
        jax_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2), *args,
        lp.arrays, mask, g, lp.E, 1e-8, 50, "mg", hier)
    out = driver.solve_linear_layered(
        make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2), *args,
        arrays, mask_t, g_t, lp.E, 1e-8, 50, "mg", hier_t)
    assert bool(ref.converged) and out.converged
    assert abs(out.iters - int(ref.iters)) <= 1, (out.iters, int(ref.iters))
    assert rel_l2(out.x, ref.x) < 1e-8
