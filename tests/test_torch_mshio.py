"""Gmsh .msh interop of the port (mesh/mshio.py), on the CPU.

The read/write round-trips of tests/test_mshio.py on the port's copy of
the module, the two copies against each other on the same file (arrays
identical), and the Poisson solve on an imported mesh through the port's
``solve_spd_cg`` (absolute 1e-10 against the solve on the original, and
against the JAX package's solve on the same mesh).
"""

import os
import tempfile

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.mesh import (  # noqa: E402
    mshio as jax_mshio)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.dfg2d import (  # noqa: E402
    dfg2d_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    assembler_for_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (  # noqa: E402
    DirichletBC, bc_mask, bc_vector)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.poisson import (  # noqa: E402
    make_poisson_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.mshio import (  # noqa: E402
    read_msh, write_msh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (  # noqa: E402
    duct_mesh, unit_square_tri)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (  # noqa: E402
    solve_spd_cg)

torch.set_num_threads(1)

# one unit square split into two triangles, bottom edge marked 7,
# left edge marked 9 (MSH 2.2 ASCII as gmsh writes it; the fixture of
# tests/test_mshio.py)
MSH22 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
4
1 1 2 7 1 1 2
2 1 2 9 4 4 1
3 2 2 1 6 1 2 3
4 2 2 1 6 1 3 4
$EndElements
"""


def _roundtrip(mesh, reader=read_msh):
    with tempfile.NamedTemporaryFile(suffix=".msh", delete=False) as f:
        path = f.name
    try:
        write_msh(path, mesh)
        return reader(path)[0]
    finally:
        os.unlink(path)


def test_read_msh22():
    with tempfile.NamedTemporaryFile(
            "w", suffix=".msh", delete=False) as f:
        f.write(MSH22)
        path = f.name
    try:
        mesh, cm = read_msh(path)
        ref, _ = jax_mshio.read_msh(path)
    finally:
        os.unlink(path)
    assert mesh.cell == "triangle"
    assert mesh.n_nodes == 4 and mesh.n_cells == 2
    assert mesh.gdim == 2
    assert np.allclose(mesh.cell_volumes().sum(), 1.0)
    assert cm is not None and set(cm) == {1}
    np.testing.assert_array_equal(mesh.nodes_with_marker(7), [0, 1])
    np.testing.assert_array_equal(mesh.nodes_with_marker(9), [0, 3])
    for k in ("points", "cells", "facets", "facet_markers"):
        assert np.array_equal(getattr(mesh, k), getattr(ref, k)), k


def test_roundtrip_dfg2d_mesh():
    mesh = dfg2d_mesh(2.0)
    mesh2 = _roundtrip(mesh)
    assert mesh2.cell == mesh.cell
    np.testing.assert_allclose(mesh2.points, mesh.points, atol=1e-15)
    np.testing.assert_array_equal(mesh2.cells, mesh.cells)
    for m in np.unique(mesh.facet_markers):
        a = {tuple(f) for f in np.sort(mesh.facets_with_marker(m), 1)}
        b = {tuple(f) for f in np.sort(mesh2.facets_with_marker(m), 1)}
        assert a == b, f"marker {m} facet set changed in round-trip"
    # a file the port wrote reads the same through the JAX package
    mesh3 = _roundtrip(mesh, jax_mshio.read_msh)
    assert np.array_equal(mesh3.points, mesh2.points)
    assert np.array_equal(mesh3.cells, mesh2.cells)


def test_roundtrip_3d():
    mesh = duct_mesh(3, 5)
    mesh2 = _roundtrip(mesh)
    assert mesh2.cell == "tetrahedron"
    np.testing.assert_allclose(mesh2.points, mesh.points, atol=1e-15)
    np.testing.assert_array_equal(mesh2.cells, mesh.cells)
    assert np.isclose(mesh2.cell_volumes().sum(),
                      mesh.cell_volumes().sum())


def _boundary_nodes(m):
    return np.unique(np.concatenate(
        [np.nonzero(np.isclose(m.points[:, d], v))[0]
         for d in (0, 1) for v in (0.0, 1.0)]))


def _solve(m):
    fs = make_space(m, 1)
    asm = assembler_for_space(fs, device="cpu")
    bnd = _boundary_nodes(m)
    bc = DirichletBC(bnd, np.zeros(len(bnd)))
    k = make_poisson_kernel(m.cell, forcing=10.0)
    return solve_spd_cg(k, fs.ndofs, 1e-12, asm.arrays,
                        asm.vector(bc_mask(fs.ndofs, bc)),
                        asm.vector(bc_vector(fs.ndofs, bc))).x.numpy()


def _solve_jax(m):
    from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import assembly
    from stabilized_navier_stokes_flow_fenicsx_tpu.fem import bc as jbc
    from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (
        make_space as jax_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu.forms.poisson import (
        make_poisson_kernel as jax_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu.solve.driver import (
        solve_spd_cg as jax_cg)

    fs = jax_space(m, 1)
    asm = assembly.assembler_for_space(fs)
    bnd = _boundary_nodes(m)
    bc = jbc.DirichletBC(bnd, np.zeros(len(bnd)))
    return np.asarray(jax_cg(
        jax_kernel(m.cell, forcing=10.0), fs.ndofs, 1e-12, asm.arrays,
        jnp.asarray(jbc.bc_mask(fs.ndofs, bc)),
        jnp.asarray(jbc.bc_vector(fs.ndofs, bc))).x)


def test_imported_mesh_solves():
    mesh = unit_square_tri(6, 6)
    mesh2 = _roundtrip(mesh)
    u1, u2 = _solve(mesh), _solve(mesh2)
    np.testing.assert_allclose(u1, u2, atol=1e-10)
    np.testing.assert_allclose(u2, _solve_jax(mesh2), atol=1e-10)
