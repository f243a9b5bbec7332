"""Iterative refinement on the block-CSR path: the port against the JAX
package's double-float refinement and the stored CPU-f64 fixtures.

* the duct SUPS problem of tests/parity_fixtures.py in float32: the f32
  Newton to rtol 1e-10 with FGMRES at 1e-6, then ``refine_newton_bcsr``
  to 1e-8: duct_ns.npz to relative L2 1e-6 (the JAX package reaches
  2.4e-8 in 1 step), the refinement steps within +-1 of JAX's on the
  same problem;
* the cavity at CAVITY size in float32 with the fixture's solver
  settings (tests/parity_fixtures.py::solve_cavity_ns): cavity_ns.npz to
  relative L2 1e-6, w (f32) and w_lo its exact split;
* ``duct_stokes.solve_duct(6, 12, SolverConfig(refine="on"))`` in f64:
  the base FGMRES count (rtol 1e-6; JAX 79) and the refinement steps
  (JAX 2) within +-1 of JAX's, u and p to relative L2 1e-8.

The channel (layered) path and ``refine_newton`` itself are
tests/test_torch_refine.py.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.apps import (  # noqa: E402
    duct_stokes as jax_duct_stokes)
from stabilized_navier_stokes_flow_fenicsx_tpu.config import (  # noqa: E402
    SolverConfig as JaxSolverConfig)
from stabilized_navier_stokes_flow_fenicsx_tpu.solve import (  # noqa: E402
    driver as jax_driver)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (  # noqa: E402
    duct_stokes, lid_driven)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    asm_arrays_in, assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (  # noqa: E402
    SolverConfig)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (  # noqa: E402
    bc_mask, bc_vector)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (  # noqa: E402
    duct_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    driver)

import parity_fixtures  # noqa: E402
from parity_fixtures import CAVITY, DUCT, FIXTURE_DIR  # noqa: E402
from torch_cases import recording, rel_l2, split_exact  # noqa: E402


def _port_duct(dtype):
    """The DUCT problem of tests/parity_fixtures.py with the port's
    modules: (W, mesh, asm, mask, g in dtype, g64)."""
    mesh = duct_mesh(DUCT["n_cross"], DUCT["n_axial"], DUCT["length"])
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, dtype=dtype, device="cpu")
    bc = duct_stokes.duct_bcs(mesh, W)
    g64 = torch.as_tensor(bc_vector(W.ndofs, bc), dtype=torch.float64)
    return (W, mesh, asm, asm.vector(bc_mask(W.ndofs, bc)), g64.to(dtype),
            g64)


def test_duct_ns_f32_refines_to_the_fixture():
    W, mesh, asm, mask, g, g64 = _port_duct(torch.float32)
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / DUCT["Re"])
    pat = asm.pattern
    zero = torch.zeros(asm.ndofs, dtype=torch.float32)
    out = driver.solve_newton_bcsr(
        kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays, mask, g,
        zero, rtol=1e-10, atol=1e-10, max_it=30, ksp_rtol=1e-6)
    n0 = float(torch.linalg.vector_norm(asm.bc_residual(kern, zero, mask,
                                                        g)))
    rres = driver.refine_newton_bcsr(
        kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays,
        asm_arrays_in(asm.arrays, mesh, torch.float64), mask, g64, out.x,
        n0, 1e-8, 0.0, 12, 1e-2)
    assert rres.converged and rres.x_hi.dtype == torch.float32
    assert rel_l2(rres.x, np.load(FIXTURE_DIR / "duct_ns.npz")["w"]) < 1e-6

    calls = []
    fn = recording(jax_driver, "refine_newton_bcsr", calls)
    try:
        w_jax = parity_fixtures.solve_duct_ns(jnp.float32, refine=True)
    finally:
        jax_driver.refine_newton_bcsr = fn
    assert abs(rres.iters - int(calls[0].iters)) <= 1
    assert rel_l2(rres.x, w_jax) < 1e-6


def test_cavity_f32_refines_to_the_fixture():
    cfg = SolverConfig(newton_rtol=1e-11, newton_atol=0.0, ksp_rtol=1e-10,
                       refine_max_it=25)
    r = lid_driven.solve_lid_driven(CAVITY["n"], CAVITY["Re"], solver=cfg,
                                    dtype=torch.float32, device="cpu")
    assert r.refined and r.converged
    w64 = split_exact(r.w, r.w_lo)
    assert rel_l2(w64, np.load(FIXTURE_DIR / "cavity_ns.npz")["w"]) < 1e-6


def test_duct_stokes_refine_on_matches_jax():
    calls, jcalls = [], []
    fn = recording(duct_stokes, "refine_newton_bcsr", calls)
    jfn = recording(jax_duct_stokes, "refine_newton_bcsr", jcalls)
    try:
        r = duct_stokes.solve_duct(6, 12, solver=SolverConfig(refine="on"),
                                   device="cpu")
        r_ref = jax_duct_stokes.solve_duct(
            6, 12, solver=JaxSolverConfig(refine="on"))
    finally:
        duct_stokes.refine_newton_bcsr = fn
        jax_duct_stokes.refine_newton_bcsr = jfn
    assert r.refined and bool(r_ref.refined)
    assert r.converged and bool(r_ref.converged)
    assert abs(r.ksp_iters - int(r_ref.ksp_iters)) <= 1
    assert abs(calls[0].iters - int(jcalls[0].iters)) <= 1
    assert rel_l2(r.u, r_ref.u) < 1e-8 and rel_l2(r.p, r_ref.p) < 1e-8
    # an f64 solve refines in f64: nothing is left over
    assert calls[0].x_hi.dtype == torch.float64
    assert not calls[0].x_lo.any()
