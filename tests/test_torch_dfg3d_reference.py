"""The DFG 3D-1Z cell's plain reference (``portbench/reference/dfg3d.py``)
against the port's layered problem, float64 on the CPU at scale 2.0
(1,834 nodes, 8,226 tets, 7,336 dofs).

* the reference's textbook SUPS residual against ``residual_layered`` at
  a seeded random state, relative 1e-12 (two sums of the same
  float64 terms in another order: ~1e-16 measured);
* its Dirichlet dofs and values against ``_pillar_bcs``, exactly (the
  same nodes and the same inflow formula), and its pillar against the
  program's marker 5;
* its reaction Cd, Cl against the program's (``reaction_from_residual``
  on the device) at a seeded random state and at the served solution,
  1e-10 absolute (the same float64 sums in another order; Cd is O(1)
  here), and the device gather against the host sum the program used
  before it, 1e-12;
* the served solution's reference residual under the cell's limit, and
  the program's float32 solve of the same ladder (the cell's control)
  over it;
* one solve records ``continuation`` with four ``rung`` spans,
  ``forces`` (> ``reaction``, ``traction``) and ``rung_krylov_its`` and
  ``rung_newton_steps`` under the four viscosities;
* the structured assembly in chunks of 498 cells and in one chunk (the
  pillar's chunk at this size), bit for bit.

The float64 solve is a module fixture; the file takes ~40 s on 4 threads.
"""

import json
import os

import numpy as np
import pytest
import torch

from portbench.reference import dfg3d as ref
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import dfg3d
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
    residual_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.forces import (
    reaction_from_residual)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import profiling

SCALE = 2.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = 0.25 * 0.014 * SCALE          # dfg3d_mesh's pillar tag at cyl_factor 1


def _limit(key):
    with open(os.path.join(ROOT, "portbench", "limits",
                           "dfg3d-1z.continuation.json")) as f:
        return json.load(f)[key]


@pytest.fixture
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def _solve(dtype):
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        prob = dfg3d.setup_dfg3d(SCALE, dtype=dtype, device="cpu")
        before = len(profiling.cases())
        r = dfg3d.solve_dfg3d_from_rest(prob)
        case = profiling.cases()[before:]
    finally:
        torch.set_num_threads(old)
    return prob, r, case


@pytest.fixture(scope="module")
def served():
    """(problem, result, the solve's program cases) in float64."""
    return _solve(torch.float64)


@pytest.fixture(scope="module")
def reference(served):
    prob = served[0]
    return ref.Problem(prob.mesh.points, prob.mesh.cells, BAND, "cpu")


def _kernel():
    return make_ns_sups_kernel("tetrahedron", nu=dfg3d.NU,
                               transposed_stab=False)


def _random_state(prob):
    rng = np.random.default_rng(20260418)
    return torch.as_tensor(0.1 * rng.standard_normal(prob.space.ndofs))


def test_residual_equals_the_programs(served, reference, threads):
    prob = served[0]
    lp = prob.lp
    w = _random_state(prob)
    r = residual_layered(_kernel(), lp.n2d, lp.n_planes, lp.bs, lp.arrays,
                         w)
    u, p = prob.space.split(w.numpy())
    F = ref.sups_residual(reference.points, reference.cells,
                          reference.state(u, p), dfg3d.NU).reshape(-1)
    assert float((F - r).norm() / r.norm()) <= 1e-12


def test_dirichlet_and_pillar_equal_the_programs(served, reference):
    prob = served[0]
    bc, obst = dfg3d._pillar_bcs(prob.mesh, prob.space)
    order = np.argsort(bc.dofs)
    fixed = reference.fixed.numpy().ravel()
    g = reference.g.numpy().ravel()
    assert np.array_equal(np.flatnonzero(fixed), bc.dofs[order])
    assert np.array_equal(g[bc.dofs[order]], bc.values[order])
    assert np.array_equal(g[~fixed], np.zeros((~fixed).sum()))
    assert np.array_equal(reference.pillar, obst)


def test_reaction_at_a_random_state(served, reference, threads):
    prob = served[0]
    lp = prob.lp
    w = _random_state(prob)
    r = residual_layered(_kernel(), lp.n2d, lp.n_planes, lp.bs, lp.arrays,
                         w)
    force = reaction_from_residual(r, prob.obst_dofs)
    r_np = r.numpy()
    host = np.array([-r_np[np.asarray(prob.space.velocity_dof(prob.obst, c))]
                     .sum() for c in range(3)])
    assert np.abs(force - host).max() <= 1e-12 * max(1.0, np.abs(host).max())
    cd, cl = dfg3d._coefficients(force)
    e = reference.evaluate(*prob.space.split(w.numpy()), dfg3d.NU)
    assert abs(cd - e["cd"]) <= 1e-10 and abs(cl - e["cl"]) <= 1e-10


def test_served_solution_against_the_reference(served, reference):
    prob, r, _ = served
    assert r.converged
    e = reference.evaluate(r.u, r.p, dfg3d.NU)
    assert abs(r.cd - e["cd"]) <= 1e-10 and abs(r.cl - e["cl"]) <= 1e-10
    assert e["residual"] <= _limit("residual")


def test_float32_control_fails_the_residual_limit(served, reference):
    _, r32, _ = _solve(torch.float32)
    e = reference.evaluate(r32.u, r32.p, dfg3d.NU)
    assert e["residual"] > _limit("residual")


def test_solve_records_its_spans_and_counters(served):
    _, r, cases = served
    assert len(cases) == 1
    c = cases[0]
    ladder = (1e-1, 1e-2, 3e-3, 1e-3)
    for name in ("continuation", "rung", "forces", "reaction", "traction",
                 "newton", "jacobian", "fgmres", "vcycle"):
        assert c.inclusive_s.get(name, 0.0) > 0.0, name
    ids = {s[0]: s for s in profiling.spans() if s[2] == c.id}
    cont = [s for s in ids.values() if s[3] == "continuation"]
    rungs = [s for s in ids.values() if s[3] == "rung"]
    assert len(cont) == 1 and len(rungs) == 4
    assert all(s[1] == cont[0][0] for s in rungs)
    forces = [s for s in ids.values() if s[3] == "forces"]
    assert len(forces) == 1
    assert sorted(s[3] for s in ids.values() if s[1] == forces[0][0]) == [
        "reaction", "traction"]
    its = c.counters["rung_krylov_its"]
    steps = c.counters["rung_newton_steps"]
    assert sorted(its) == sorted(ladder) and sorted(steps) == sorted(ladder)
    for nu, n_steps, ksp, _fnorm, _wall in r.rungs:
        assert its[nu] == sum(ksp) and steps[nu] == n_steps


def test_chunked_assembly_is_bitwise_the_same(served, threads):
    """The structured route's chunk (``build_layered(chunk_cells=)``;
    the pillar's is its whole mesh here, under ``ASM_CHUNK_CELLS``)
    changes only how many cells one kernel call takes: chunks of 498
    cells against one of 8,226, the Jacobian values and the residual at
    a random state bit for bit."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        build_layered, matrix_values_layered)

    prob = served[0]
    np2, Lp, _ = prob.mesh.layered
    small = build_layered(prob.space, np2, Lp, torch.float64, "cpu",
                          chunk_cells=500)
    assert prob.lp.arrays.sasm.chunk_cells == prob.mesh.n_cells
    w = _random_state(prob)
    k = _kernel()
    V = [matrix_values_layered(k, p.E, p.n_planes, p.bs, p.arrays, w)
         for p in (prob.lp, small)]
    R = [residual_layered(k, p.n2d, p.n_planes, p.bs, p.arrays, w)
         for p in (prob.lp, small)]
    assert torch.equal(V[0], V[1]) and torch.equal(R[0], R[1])
