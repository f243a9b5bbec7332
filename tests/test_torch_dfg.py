"""The port's DFG cylinder benchmarks against the JAX package: meshes,
force functionals and the 2D-1 solve.  Float64 on the CPU.

* ``dfg2d_mesh(1.0)``, ``dfg3d_mesh(2.0)`` (both bands), the
  ``structured_annulus`` and ``triangulate_sizefield`` of
  mesh/sizefield.py: points, cells, facets and markers
  ``np.array_equal`` to the JAX package's (the mesher is a copy, and
  the dart throwing keeps its seed);
* ``dfg_2d_coefficients``, ``traction_force_3d`` and ``reaction_force``
  on seeded fields: relative 1e-12;
* ``solve_dfg2d(1.0)``: Cd, Cl and the surface values relative 1e-8 of
  JAX's, the same Newton count, fields relative 1e-8, and the bars of
  tests/test_dfg.py at this scale (converged, Cd within 1% of the
  literature value, 0.001 < Cl < 0.1);
* ``main`` of both apps at a coarse scale: the JAX app's printed lines,
  every figure relative 1e-7; without a card and without
  ``device="cpu"`` they raise.

The DFG 3D solves are in tests/test_torch_dfg3d.py.
"""

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.apps import (  # noqa: E402
    dfg2d as jax_dfg2d, dfg3d as jax_dfg3d)
from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import (  # noqa: E402
    assembly as jax_assembly)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (  # noqa: E402
    make_mixed_space as jax_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu.flow import (  # noqa: E402
    forces as jax_forces)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms import (  # noqa: E402
    navier_stokes as jax_ns)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh import (  # noqa: E402
    sizefield as jax_sizefield)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (  # noqa: E402
    dfg2d, dfg3d)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow import (  # noqa: E402
    forces)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms import (  # noqa: E402
    navier_stokes)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh import (  # noqa: E402
    sizefield)

from torch_cases import rel_l2  # noqa: E402

torch.set_num_threads(1)


def _same_mesh(a, b):
    assert a.cell == b.cell
    for k in ("points", "cells", "facets", "facet_markers"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


MESHES = {
    "dfg2d": lambda m: m.dfg2d_mesh(1.0),
    "dfg2d_rings": lambda m: m.dfg2d_mesh(2.0, symmetric_band=False),
    "dfg3d": lambda m: m.dfg3d_mesh(2.0),
    "dfg3d_fine_growth": lambda m: m.dfg3d_mesh(2.0, near_growth=0.15),
    "dfg3d_no_band": lambda m: m.dfg3d_mesh(3.0, symmetric_band=False),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_identical_to_jax(name):
    mods = (jax_dfg2d, dfg2d) if name.startswith("dfg2d") \
        else (jax_dfg3d, dfg3d)
    ref, got = (MESHES[name](m) for m in mods)
    _same_mesh(got, ref)
    if name.startswith("dfg3d"):
        n2d, n_planes, used = got.layered
        assert n2d * n_planes == got.n_nodes and used.all()
        assert np.array_equal(np.unique(got.points[:, 2]),
                              got.points[::n2d, 2])


def test_sizefield_pieces_identical_to_jax():
    center = np.array([0.2, 0.2])
    outs = [m.structured_annulus(center, 0.05, 0.004, n_layers=4)
            for m in (jax_sizefield, sizefield)]
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    apts, _tris, _inner, outer_ids = outs[0]
    rect = np.array([[0, 0], [1.0, 0], [1.0, 0.41], [0, 0.41]])

    def lc_fn(p):
        p = np.atleast_2d(p)
        d = np.hypot(p[:, 0] - 0.2, p[:, 1] - 0.2) - 0.05
        return 0.01 + 0.2 * np.maximum(d, 0.0)

    meshes = [m.triangulate_sizefield(
        rect, [], lc_fn, lc_min=0.01, fixed_hole_loops=[apts[outer_ids]])
        for m in (jax_sizefield, sizefield)]
    _same_mesh(meshes[1], meshes[0])
    rings = [m.boundary_layer_rings(center, 0.05, 0.004)
             for m in (jax_sizefield, sizefield)]
    assert np.array_equal(rings[0], rings[1])


def test_force_functionals_on_seeded_fields():
    rng = np.random.default_rng(21)
    m2 = dfg2d.dfg2d_mesh(2.0)
    u2, p2 = rng.normal(size=(m2.n_nodes, 2)), rng.normal(size=m2.n_nodes)
    got = forces.dfg_2d_coefficients(m2, u2, p2, 5, 1e-3)
    ref = jax_forces.dfg_2d_coefficients(m2, u2, p2, 5, 1e-3)
    np.testing.assert_allclose(got, ref, rtol=1e-12)

    m3 = dfg3d.dfg3d_mesh(3.0)
    u3, p3 = rng.normal(size=(m3.n_nodes, 3)), rng.normal(size=m3.n_nodes)
    np.testing.assert_allclose(
        forces.traction_force_3d(m3, u3, p3, 5, 1e-3),
        jax_forces.traction_force_3d(m3, u3, p3, 5, 1e-3), rtol=1e-12)

    w = 0.1 * rng.normal(size=4 * m3.n_nodes)
    W, Wj = make_mixed_space(m3, 1, 1), jax_mixed_space(m3, 1, 1)
    got = forces.reaction_force(
        assembler_for_mixed(W, device="cpu"),
        navier_stokes.make_ns_sups_kernel("tetrahedron", 1e-2,
                                          transposed_stab=False),
        W, m3, w, 5)
    ref = jax_forces.reaction_force(
        jax_assembly.assembler_for_mixed(Wj),
        jax_ns.make_ns_sups_kernel("tetrahedron", nu=1e-2,
                                   transposed_stab=False),
        Wj, m3, w, 5)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_solve_dfg2d_against_jax_and_the_literature():
    r = dfg2d.solve_dfg2d(1.0, device="cpu")
    ref = jax_dfg2d.solve_dfg2d(1.0)
    _same_mesh(r.mesh, ref.mesh)
    assert r.converged and ref.converged
    assert r.newton_iters == ref.newton_iters
    assert len(r.rung_iters) == 4 and r.rung_iters[-1] == r.newton_iters
    for k in ("cd", "cl", "cd_surface", "cl_surface"):
        a, b = getattr(r, k), getattr(ref, k)
        assert abs(a - b) <= 1e-8 * abs(b), (k, a, b)
    assert rel_l2(r.u, ref.u) <= 1e-8 and rel_l2(r.p, ref.p) <= 1e-8
    # tests/test_dfg.py:41-46
    assert abs(r.cd - dfg2d.CD_REF) / dfg2d.CD_REF < 0.01, r.cd
    assert 0.001 < r.cl < 0.1, r.cl
    assert set(r.timings) == {"mesh_s", "stokes_s", "assembly_s", "index_s",
                              "lu_s"}


def _figures(lines):
    return [(ln.split(":")[0], float(ln.split(":")[1])) for ln in lines]


@pytest.mark.parametrize("app,argv", [("dfg2d", ["2.0"]),
                                      ("dfg3d", ["3.0"])])
def test_main_prints_what_jax_prints(app, argv, capsys):
    mod, jmod = (dfg2d, jax_dfg2d) if app == "dfg2d" else (dfg3d, jax_dfg3d)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mod.main(argv)
        capsys.readouterr()
    mod.main(argv, device="cpu")
    out = _figures(capsys.readouterr().out.splitlines())
    jmod.main(argv)
    ref = _figures(capsys.readouterr().out.splitlines())
    assert len(out) == len(ref) == (6 if app == "dfg2d" else 3)
    for (ka, va), (kb, vb) in zip(out, ref):
        assert ka == kb
        assert abs(va - vb) <= 1e-7 * abs(vb), (ka, va, vb)
