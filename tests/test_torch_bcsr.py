"""The generic block-CSR path of the port against the JAX package.

Float64 on the CPU, the same meshes and seeded states on both sides:

* ``build_pattern``: native and numpy arrays identical, and equal to the
  JAX package's;
* ``residual_of``, ``matrix_values_of`` and ``bcsr_matvec`` on the duct
  (tetrahedra, SUPS; tests/parity_fixtures.py's DUCT mesh) and the cavity
  (triangles, UGN; CAVITY's mesh), on the JAX package's ``AsmArrays``
  handed over through ``convert.py``: relative L2 1e-12;
* the UGN kernel's residual and hand-derived tangent on triangles and
  tetrahedra (cells at rest included, where the |u| guard holds):
  relative 1e-12 against JAX, and the tangent against
  ``torch.func.jacfwd`` of the residual;
* Poisson through ``assembler_for_space`` + ``solve_spd_cg`` (matrix
  free) and through ``linear_system`` + Jacobi CG: relative 1e-10;
* ``solve_linear_bcsr`` (duct Stokes) and ``solve_newton_bcsr`` (duct
  SUPS Navier-Stokes, Re=20): iterations within +-1, x relative 1e-8.
"""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import (  # noqa: E402
    assembly as jax_assembly)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem.bc import (  # noqa: E402
    DirichletBC)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (  # noqa: E402
    make_mixed_space as jax_mixed_space, make_space as jax_space)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms import (  # noqa: E402
    navier_stokes as jax_ns, poisson as jax_poisson, stokes as jax_stokes)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh import (  # noqa: E402
    structured as jax_structured)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh.core import (  # noqa: E402
    boundary_facets)
from stabilized_navier_stokes_flow_fenicsx_tpu.solve import (  # noqa: E402
    driver as jax_driver, krylov as jax_krylov, precond as jax_precond)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch import (  # noqa: E402
    convert)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (  # noqa: E402
    assembly)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms import (  # noqa: E402
    navier_stokes, poisson, stokes)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh import (  # noqa: E402
    structured)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    driver, krylov, precond)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.native import (  # noqa: E402
    build_pattern_native)

from parity_fixtures import CAVITY, DUCT, duct_problem  # noqa: E402
from torch_cases import numpy_fields, rel_l2  # noqa: E402

MESHES = ("duct", "cavity")


def _jax_mesh(name):
    if name == "duct":
        return jax_structured.duct_mesh(DUCT["n_cross"], DUCT["n_axial"],
                                        DUCT["length"])
    return jax_structured.unit_square_tri(CAVITY["n"], CAVITY["n"])


def _kernels(name):
    """(JAX, port) Navier-Stokes kernels: SUPS on the duct, UGN on the
    cavity."""
    if name == "duct":
        nu = 1.0 / DUCT["Re"]
        return (jax_ns.make_ns_sups_kernel("tetrahedron", nu=nu),
                navier_stokes.make_ns_sups_kernel("tetrahedron", nu))
    nu = 1.0 / CAVITY["Re"]
    return (jax_ns.make_ns_ugn_kernel("triangle", nu=nu),
            navier_stokes.make_ns_ugn_kernel("triangle", nu))


@pytest.fixture(scope="module", params=MESHES)
def mixed(request):
    """(name, JAX assembler, the port's arrays from it, seeded w, x)."""
    jmesh = _jax_mesh(request.param)
    jasm = jax_assembly.assembler_for_mixed(jax_mixed_space(jmesh, 1, 1))
    arrays = convert.asm_arrays(numpy_fields(jasm.arrays), "cpu")
    rng = np.random.default_rng(11)
    w = rng.normal(size=jasm.ndofs) * 0.3
    x = rng.normal(size=jasm.ndofs)
    return request.param, jasm, arrays, w, x


@pytest.mark.parametrize("name", MESHES)
def test_build_pattern_native_numpy_jax(name):
    jmesh = _jax_mesh(name)
    W = jax_mixed_space(jmesh, 1, 1)
    cb, n = W.V.cell_dofs_scalar, W.V.n_scalar_dofs
    assert build_pattern_native(cb, n) is not None
    nat = assembly.build_pattern(cb, n, W.block_size)
    nump = assembly._build_pattern_np(cb, n, W.block_size)
    ref = convert.block_pattern(dataclasses.asdict(
        jax_assembly.build_pattern(cb, n, W.block_size)))
    for k in ("indptr", "indices", "row_ids", "ell_pos", "diag_pos"):
        assert np.array_equal(getattr(nat, k), getattr(nump, k)), k
        assert np.array_equal(getattr(nat, k), getattr(ref, k)), k
    assert (nat.n_rows, nat.bs, nat.nnzb) == (ref.n_rows, ref.bs, ref.nnzb)


def test_residual_of(mixed):
    name, jasm, arrays, w, _ = mixed
    kj, kt = _kernels(name)
    r_ref = jasm.residual(kj, jnp.asarray(w))
    r = assembly.residual_of(kt, jasm.ndofs, arrays, torch.tensor(w))
    assert rel_l2(r, r_ref) <= 1e-12


def test_matrix_values_of(mixed):
    name, jasm, arrays, w, _ = mixed
    kj, kt = _kernels(name)
    pat = jasm.pattern
    V_ref = jasm.matrix_values(kj, jnp.asarray(w))
    V = assembly.matrix_values_of(kt, pat.nnzb, pat.bs, arrays,
                                  torch.tensor(w))
    assert V.shape == (pat.nnzb, pat.bs, pat.bs)
    assert rel_l2(V, V_ref) <= 1e-12


def test_bcsr_matvec(mixed):
    name, jasm, arrays, w, x = mixed
    kj, _ = _kernels(name)
    V = np.asarray(jasm.matrix_values(kj, jnp.asarray(w)))
    y_ref = jasm.matvec(jnp.asarray(V), jnp.asarray(x))
    y = assembly.bcsr_matvec(arrays, jasm.pattern.n_rows, torch.tensor(V),
                             torch.tensor(x))
    assert rel_l2(y, y_ref) <= 1e-12
    # and against scipy's product of the same block-CSR matrix
    A = assembly.BlockPattern(**{
        k: getattr(jasm.pattern, k) for k in (
            "n_rows", "bs", "indptr", "indices", "row_ids", "ell_pos",
            "diag_pos")}).to_scipy(torch.tensor(V))
    assert rel_l2(y, A @ x) <= 1e-12


def test_assembler_matches_jax_arrays(mixed):
    """The port's own ``assembler_for_mixed`` builds the JAX arrays."""
    name, jasm, arrays, _, _ = mixed
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
        make_mixed_space)

    mesh = (structured.duct_mesh(DUCT["n_cross"], DUCT["n_axial"],
                                 DUCT["length"]) if name == "duct"
            else structured.unit_square_tri(CAVITY["n"], CAVITY["n"]))
    tasm = assembly.assembler_for_mixed(make_mixed_space(mesh, 1, 1),
                                        device="cpu")
    assert tasm.ndofs == jasm.ndofs and tasm.dtype == torch.float64
    for f in dataclasses.fields(arrays):
        a, b = getattr(tasm.arrays, f.name), getattr(arrays, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def _ugn_cells(cell, n=6):
    """n seeded cells (coords, w); the last has zero velocity, so the
    |u| <= 1e-8 guard holds on it."""
    rng = np.random.default_rng(4)
    dim = 2 if cell == "triangle" else 3
    ref = np.vstack([np.zeros(dim), np.eye(dim)])
    coords = ref[None] + 0.15 * rng.normal(size=(n, dim + 1, dim))
    w = rng.normal(size=(n, (dim + 1) * (dim + 1)))
    w[-1].reshape(dim + 1, dim + 1)[:, :dim] = 0.0
    return coords, w


@pytest.mark.parametrize("cell", ["triangle", "tetrahedron"])
def test_ugn_kernel(cell):
    coords, w = _ugn_cells(cell)
    kj = jax_ns.make_ns_ugn_kernel(cell, nu=0.02)
    kt = navier_stokes.make_ns_ugn_kernel(cell, 0.02)
    # the SoA pair rides along on tetrahedra only, as in the JAX package
    assert (kt.soa is None) == (cell == "triangle")
    assert (getattr(kj, "res_soa", None) is None) == (kt.soa is None)
    r_ref = jax.vmap(kj)(jnp.asarray(coords), jnp.asarray(w))
    J_ref = jax.vmap(kj.jac)(jnp.asarray(coords), jnp.asarray(w))
    ct, wt = torch.tensor(coords), torch.tensor(w)
    r = torch.func.vmap(kt)(ct, wt)
    J = torch.func.vmap(kt.jac)(ct, wt)
    J_ad = torch.func.vmap(
        lambda c, ww: torch.func.jacfwd(lambda v: kt(c, v))(ww))(ct, wt)
    assert rel_l2(r, r_ref) <= 1e-12
    assert rel_l2(J, J_ref) <= 1e-12
    assert rel_l2(J, J_ad) <= 1e-12
    assert torch.isfinite(J[-1]).all()


def _poisson_case(cell):
    if cell == "triangle":
        return (jax_structured.unit_square_tri(8, 8),
                structured.unit_square_tri(8, 8))
    n, lo, hi = (3, 3, 3), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    return (jax_structured.box_tet(n, lo, hi), structured.box_tet(n, lo, hi))


@pytest.mark.parametrize("cell", ["triangle", "tetrahedron"])
def test_poisson_solve_spd_cg(cell):
    jmesh, tmesh = _poisson_case(cell)
    jasm = jax_assembly.assembler_for_space(jax_space(jmesh, 1))
    tasm = assembly.assembler_for_space(make_space(tmesh, 1), device="cpu")
    bnodes = np.unique(boundary_facets(jmesh).ravel())
    mask = np.ones(jasm.ndofs)
    mask[bnodes] = 0.0
    g = np.zeros(jasm.ndofs)
    g[bnodes] = 0.1 * tmesh.points[bnodes, 0]
    kj = jax_poisson.make_poisson_kernel(cell, 1, forcing=10.0)
    kt = poisson.make_poisson_kernel(cell, 1, forcing=10.0)
    ref = jax_driver.solve_spd_cg(kj, jasm.ndofs, 1e-12, jasm.arrays,
                                  jnp.asarray(mask), jnp.asarray(g))
    out = driver.solve_spd_cg(kt, tasm.ndofs, 1e-12, tasm.arrays,
                              torch.tensor(mask), torch.tensor(g))
    assert out.converged and bool(ref.converged)
    assert abs(out.iters - int(ref.iters)) <= 1
    assert rel_l2(out.x, ref.x) <= 1e-10


def test_poisson_linear_system_jacobi_cg():
    """tests/test_poisson.py's route: linear_system + scalar Jacobi CG,
    and the assembled matrix through ``to_scipy``."""
    jmesh, tmesh = _poisson_case("triangle")
    jasm = jax_assembly.assembler_for_space(jax_space(jmesh, 1))
    tasm = assembly.assembler_for_space(make_space(tmesh, 1), device="cpu")
    bnodes = np.unique(boundary_facets(jmesh).ravel())
    bc = DirichletBC(bnodes, np.zeros(len(bnodes)))
    kj = jax_poisson.make_poisson_kernel("triangle", 1, forcing=10.0)
    kt = poisson.make_poisson_kernel("triangle", 1, forcing=10.0)
    vj, Aj, bj, mj = jasm.linear_system(kj, bc)
    vt, At, bt, mt = tasm.linear_system(kt, bc)
    A_ref = jasm.pattern.to_scipy(np.asarray(vj)).toarray()
    assert rel_l2(tasm.pattern.to_scipy(vt).toarray(), A_ref) <= 1e-12
    assert rel_l2(bt, bj) <= 1e-12
    ref = jax_krylov.cg(Aj, bj, M=jax_precond.scalar_jacobi(
        jasm.diag_blocks(vj)[:, 0, 0], mj), rtol=1e-12)
    out = krylov.cg(At, bt, M=precond.scalar_jacobi(
        tasm.diag_blocks(vt)[:, 0, 0], mt), rtol=1e-12)
    assert out.converged and abs(out.iters - int(ref.iters)) <= 1
    assert rel_l2(out.x, ref.x) <= 1e-10
    assert precond.identity_pc()(out.x) is out.x


@pytest.fixture(scope="module")
def duct():
    """tests/parity_fixtures.py's DUCT problem, JAX and port."""
    W, jasm, mask, g, _ = duct_problem(jnp.float64, **DUCT)
    arrays = convert.asm_arrays(numpy_fields(jasm.arrays), "cpu")
    return jasm, arrays, mask, g


def test_solve_linear_bcsr(duct):
    jasm, arrays, mask, g = duct
    pat = jasm.pattern
    args = (jasm.ndofs, pat.nnzb, pat.bs, pat.n_rows, 1e-10, 50)
    ref = jax_driver.solve_linear_bcsr(
        jax_stokes.make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2),
        *args, jasm.arrays, mask, g)
    out = driver.solve_linear_bcsr(
        stokes.make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2),
        *args, arrays, torch.tensor(np.asarray(mask)),
        torch.tensor(np.asarray(g)))
    assert out.converged and bool(ref.converged)
    assert abs(out.iters - int(ref.iters)) <= 1, (out.iters, int(ref.iters))
    assert rel_l2(out.x, ref.x) <= 1e-8


def test_solve_newton_bcsr(duct):
    jasm, arrays, mask, g = duct
    pat = jasm.pattern
    kj, kt = _kernels("duct")
    args = (jasm.ndofs, pat.nnzb, pat.bs, pat.n_rows)
    ref = jax_driver.solve_newton_bcsr(
        kj, *args, jasm.arrays, mask, g, jnp.zeros(jasm.ndofs),
        rtol=1e-10, atol=1e-10, max_it=30, ksp_rtol=1e-10)
    out = driver.solve_newton_bcsr(
        kt, *args, arrays, torch.tensor(np.asarray(mask)),
        torch.tensor(np.asarray(g)), torch.zeros(jasm.ndofs, dtype=torch.float64),
        rtol=1e-10, atol=1e-10, max_it=30, ksp_rtol=1e-10)
    assert out.converged and bool(ref.converged)
    assert out.iters == int(ref.iters)
    h_ref = np.asarray(ref.history)[:out.iters]
    assert np.abs(out.history[:, 2] - h_ref[:, 2]).max() <= 1
    assert rel_l2(out.x, ref.x) <= 1e-8
