"""The port's DFG 3D-1Z solves, float64 on the CPU.

* ``solve_dfg3d(2.0)`` (host LU, 1,519 nodes) against the JAX package's:
  Cd, Cl and the surface values relative 1e-8, the same Newton count,
  fields relative 1e-8, and the drag bar of tests/test_dfg.py (within 5%
  of 6.18);
* ``solve_dfg3d_fine(2.0)`` (the layered path: structured assembly, the
  layered SpMV's plain version, the mg-Chebyshev V-cycle with bf16
  values, FGMRES Newton) against the port's own ``solve_dfg3d(2.0,
  near_growth=0.15)`` on the same mesh: fields relative L2 < 1e-6, Cd
  relative < 1e-5, i.e. the layered path and the host-LU path solve one
  discrete problem; its progress lines keep the JAX app's format;
* the hierarchy's two ends: at scale 2.0 one coarsening reaches the
  dense solve; a hierarchy whose coarsest level is too large for the
  dense solve relaxes it, as the JAX package does;
* without a card and without ``device="cpu"`` both entry points raise.
"""

import contextlib
import io
import re

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.apps import (  # noqa: E402
    dfg3d as jax_dfg3d)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (  # noqa: E402
    dfg3d)

from torch_cases import rel_l2  # noqa: E402

torch.set_num_threads(1)


def test_solve_dfg3d_against_jax():
    r = dfg3d.solve_dfg3d(2.0, device="cpu")
    ref = jax_dfg3d.solve_dfg3d(2.0)
    assert np.array_equal(r.mesh.points, ref.mesh.points)
    assert np.array_equal(r.mesh.cells, ref.mesh.cells)
    assert r.converged and ref.converged
    assert r.newton_iters == ref.newton_iters
    for k in ("cd", "cl", "cd_surface", "cl_surface"):
        a, b = getattr(r, k), getattr(ref, k)
        assert abs(a - b) <= 1e-8 * abs(b), (k, a, b)
    assert rel_l2(r.u, ref.u) <= 1e-8 and rel_l2(r.p, ref.p) <= 1e-8
    assert abs(r.cd - 6.18) / 6.18 < 0.05, r.cd


@pytest.fixture(scope="module")
def fine():
    """(result, printed lines) of the layered solve at scale 2.0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = dfg3d.solve_dfg3d_fine(2.0, device="cpu")
    return r, buf.getvalue().splitlines()


def test_layered_path_solves_the_host_lu_problem(fine):
    r, _ = fine
    ref = dfg3d.solve_dfg3d(2.0, near_growth=0.15, device="cpu")
    assert np.array_equal(r.mesh.points, ref.mesh.points)
    assert np.array_equal(r.mesh.cells, ref.mesh.cells)
    assert r.converged and ref.converged
    assert rel_l2(r.u, ref.u) < 1e-6 and rel_l2(r.p, ref.p) < 1e-6
    assert abs(r.cd - ref.cd) / abs(ref.cd) < 1e-5
    assert abs(r.cl - ref.cl) / abs(ref.cl) < 1e-4
    assert abs(r.cd_surface - ref.cd_surface) / abs(ref.cd_surface) < 1e-5


def test_fine_rungs_and_progress_lines(fine):
    r, lines = fine
    assert [nu for nu, *_ in r.rungs] == [1e-1, 1e-2, 3e-3, 1e-3]
    for _nu, its, ksp, fnorm, wall in r.rungs:
        assert its == len(ksp) and 1 <= its <= 30
        assert all(1 <= k < 2000 for k in ksp)
        assert fnorm < 1e-8 and wall > 0.0
    assert r.newton_iters == r.rungs[-1][1]
    pats = [r"dfg3d_fine: 1834 nodes, 8226 tets, 7336 dofs, n2d=262 Lp=7 "
            r"\(setup \d+\.\ds\)"]
    pats += [rf"dfg3d_fine: nu={nu} its=\d+ \|F\|=\d\.\d{{3}}e-\d\d "
             r"\(\d+\.\ds\)" for nu in ("0.1", "0.01", "0.003", "0.001")]
    pats += [r"dfg3d_fine: Cd=\d\.\d{5} Cl=-?\d\.\d{6} \(surface "
             r"Cd=\d\.\d{5} Cl=-?\d\.\d{6}\) total \d+\.\ds"]
    assert len(lines) == len(pats)
    for ln, pat in zip(lines, pats):
        assert re.fullmatch(pat, ln), ln


def test_coarsest_level_beyond_the_dense_solve_raises(monkeypatch):
    """A hierarchy whose coarsest level is too large for the dense solve
    (scale 2.0, no coarsening, ``dense_cap`` below its dofs): the dense
    solve is refused and, as in the JAX package, the level is relaxed
    with its smoother ``n_coarse_sweeps`` times.  One apply of the
    V-cycle on the pillar's Navier-Stokes Jacobian at the BC lift against
    the JAX package's (Chebyshev smoother in f32 on both sides: 1e-5)."""
    import jax
    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx_tpu.solve import (
        mg as jax_mg)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        matrix_values_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import mg

    def no_dense(op):
        raise AssertionError("the dense coarse solve was built")

    monkeypatch.setattr(mg, "_dense_coarse_inverse", no_dense)
    _, _, lp, mask, g, hier, _ = dfg3d._fine_setup(2.0, 1.0, 0.3, 0, "cpu")
    a = lp.arrays
    assert not hier.levels
    cap = lp.ndofs - 1
    V = matrix_values_layered(
        make_ns_sups_kernel("tetrahedron", nu=dfg3d.NU,
                            transposed_stab=False),
        lp.E, lp.n_planes, lp.bs, a, g)
    r = np.random.default_rng(2).standard_normal(lp.ndofs)
    x = mg.make_mg_pc(hier, V, a.cols, a.row_ids, a.row_ptr, a.diag_pos,
                      mask, lp.n2d, lp.n_planes, smoother="cheby",
                      dense_cap=cap)(torch.as_tensor(r))
    x_ref = jax.jit(lambda v, b: jax_mg.make_mg_pc(
        jax_mg.MGHierarchy(levels=(), dims=()), v,
        jnp.asarray(a.cols.numpy()), jnp.asarray(a.row_ids.numpy()),
        jnp.asarray(a.diag_pos.numpy()), jnp.asarray(mask.numpy()),
        lp.n2d, lp.n_planes, smoother="cheby", dense_cap=cap)(b))(
            jnp.asarray(V.numpy()), jnp.asarray(r))
    assert torch.isfinite(x).all() and rel_l2(x, x_ref) <= 1e-5


@pytest.mark.parametrize("fn", [dfg3d.solve_dfg3d, dfg3d.solve_dfg3d_fine])
def test_raises_without_a_card(fn):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn(3.0)
