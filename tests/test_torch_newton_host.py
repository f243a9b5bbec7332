"""The port's host-LU drivers (solve/newton_host.py) against the JAX
package, float64 on the CPU.

* ``linear_host_lu`` on the duct Stokes problem (tests/parity_fixtures.py
  DUCT mesh) and on the Taylor-Hood duct, whose inlet-rim pressure rows
  are null pivots (identity row, zero value): x relative 1e-10, and the
  null-pivot dofs exactly zero on both sides;
* ``newton_host_lu`` on the duct SUPS Navier-Stokes problem from a seeded
  perturbation of the Stokes field, and on the Burgers example kernel
  (examples/burgers_1d.py): x relative 1e-10, the same iteration count
  and the same line-search lambda history, |F| history relative 1e-6
  with absolute 1e-12 (it ends at roundoff level);
* a start that needs backtracking (Burgers at nu = 0.02 from the linear
  guess: lambda 0.25, 0.5, then full steps) takes the same lambdas on
  both sides, x relative 1e-6 (the shock position is exponentially
  ill-conditioned there; at lower nu the first Jacobians are so ill-conditioned
  that roundoff picks the lambdas, in JAX and in the port alike));
* the assembler's device is used: tensors, numpy arrays and lists are
  accepted for mask, g and w0 alike, and ``timings`` is filled.
"""

import importlib.util
import pathlib

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import (  # noqa: E402
    assembly as jax_assembly)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (  # noqa: E402
    make_space as jax_space)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms import (  # noqa: E402
    navier_stokes as jax_ns, stokes as jax_stokes)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh.structured import (  # noqa: E402
    unit_interval)
from stabilized_navier_stokes_flow_fenicsx_tpu.solve import (  # noqa: E402
    newton_host as jax_newton_host)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    assembler_for_mixed, assembler_for_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (  # noqa: E402
    DirichletBC, bc_mask, bc_vector)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms import (  # noqa: E402
    navier_stokes, stokes)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.newton_host import (  # noqa: E402
    HostNewtonResult, linear_host_lu, newton_host_lu)

from parity_fixtures import DUCT, duct_problem  # noqa: E402
from torch_cases import rel_l2  # noqa: E402

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _example(stem):
    spec = importlib.util.spec_from_file_location(
        f"_example_{stem}", EXAMPLES / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def duct():
    """(JAX assembler, the port's on the same mesh, mask, g) of DUCT."""
    W, jasm, mask, g, _g64 = duct_problem(
        jnp.float64, DUCT["n_cross"], DUCT["n_axial"], DUCT["length"],
        DUCT["Re"])
    asm = assembler_for_mixed(W, device="cpu")
    return jasm, asm, np.asarray(mask), np.asarray(g)


def _same_newton(res, ref, x_tol=1e-10):
    assert isinstance(res, HostNewtonResult)
    assert res.iters == ref.iters and res.converged == ref.converged
    assert [lam for _, lam in res.history] == \
        [lam for _, lam in ref.history]
    assert rel_l2(res.x, ref.x) <= x_tol
    np.testing.assert_allclose([f for f, _ in res.history[:-1]],
                               [f for f, _ in ref.history[:-1]], rtol=1e-6,
                               atol=1e-12)


def test_linear_host_lu_duct(duct):
    jasm, asm, mask, g = duct
    ref = jax_newton_host.linear_host_lu(
        jasm, jax_stokes.make_stokes_kernel("tetrahedron", 1.0, 0.2),
        jnp.asarray(mask), jnp.asarray(g))
    x = linear_host_lu(
        asm, stokes.make_stokes_kernel("tetrahedron", 1.0, 0.2),
        asm.vector(mask), asm.vector(g))
    assert isinstance(x, np.ndarray) and x.dtype == np.float64
    assert rel_l2(x, ref) <= 1e-10
    assert np.array_equal(x[mask < 0.5], g[mask < 0.5])


def test_newton_host_lu_duct(duct):
    jasm, asm, mask, g = duct
    nu = 1.0 / DUCT["Re"]
    x0 = jax_newton_host.linear_host_lu(
        jasm, jax_stokes.make_stokes_kernel("tetrahedron", 1.0, 0.2),
        jnp.asarray(mask), jnp.asarray(g))
    rng = np.random.default_rng(3)
    x0 = x0 + 0.05 * mask * rng.normal(size=x0.shape)
    ref = jax_newton_host.newton_host_lu(
        jasm, jax_ns.make_ns_sups_kernel("tetrahedron", nu=nu),
        jnp.asarray(mask), jnp.asarray(g), jnp.asarray(x0))
    timings = {}
    res = newton_host_lu(
        asm, navier_stokes.make_ns_sups_kernel("tetrahedron", nu),
        mask, g, x0, timings=timings)
    assert ref.converged and ref.iters >= 3
    _same_newton(res, ref)
    assert all(timings[k] > 0.0 for k in ("assembly_s", "index_s", "lu_s"))


@pytest.mark.parametrize("nu,max_it", [(0.05, 30), (0.02, 30)],
                         ids=["full_steps", "backtracking"])
def test_newton_host_lu_burgers(nu, max_it):
    n = 128
    mesh = unit_interval(n)
    bc = DirichletBC(np.array([0, n]), np.array([1.0, -1.0]))
    mask, g = bc_mask(n + 1, bc), bc_vector(n + 1, bc)
    x0 = 1.0 - 2.0 * mesh.points[:, 0]
    ref = jax_newton_host.newton_host_lu(
        jax_assembly.assembler_for_space(jax_space(mesh, 1)),
        _example("burgers_1d").make_kernel(nu), jnp.asarray(mask),
        jnp.asarray(g), jnp.asarray(x0), rtol=1e-12, max_it=max_it)
    asm = assembler_for_space(make_space(mesh, 1), device="cpu")
    res = newton_host_lu(
        asm, _example("torch_burgers_1d").make_kernel(nu),
        torch.tensor(mask), list(g), torch.tensor(x0), rtol=1e-12,
        max_it=max_it)
    # at nu = 0.02 the shock's position is fixed only by terms of size
    # exp(-1/(2 nu)): both sides reach |F| ~ 1e-13 with x 2.5e-7 apart
    _same_newton(res, ref, x_tol=1e-10 if nu == 0.05 else 1e-6)
    if nu < 0.05:
        assert [lam for _, lam in ref.history[:2]] == [0.25, 0.5]


def test_newton_host_lu_at_the_solution_takes_no_step(duct):
    _jasm, asm, mask, g = duct
    kern = stokes.make_stokes_kernel("tetrahedron", 1.0, 0.2)
    x = linear_host_lu(asm, kern, mask, g)
    res = newton_host_lu(asm, kern, mask, g, x, rtol=1e-9, atol=1e-9)
    assert res.iters == 0 and res.converged and res.history == []
    assert np.array_equal(res.x, x)
