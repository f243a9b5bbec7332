"""Square-duct Stokes flow — the reference's known-output smoke test.

Counterpart of the JAX package's ``apps/duct_stokes.py``, reimplementing
reference StokesFlow/DuctStokesFlow.py: a square duct x in [0, L],
cross-section (-0.5, 0.5)^2, inlet velocity Dirichlet, no-slip walls,
outlet pressure 0 (reference :156-183).  The duct is a native structured
tet mesh solved with the stabilized P1-P1 form + FGMRES on the block-CSR
path; for exact-profile inflow the solution must stay fully developed
(README.md:44-56).  The solve runs on the card (``device="cpu"`` runs it
on the CPU).  ``dtype=`` stands in for the JAX package's global x64
switch: with refinement on (``solver.refine``; "auto" on float32) the
Krylov solve stops at rtol 1e-6 and iterative refinement with an f64
residual (solve/refine.py) carries it to 1e-10.

    python -m stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.duct_stokes [n]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..assemble.assembly import asm_arrays_in, assembler_for_mixed
from ..config import SolverConfig, default_dtype
from ..fem.bc import DirichletBC, bc_mask, bc_vector, combine_bcs
from ..fem.space import MixedVelocityPressureSpace, make_mixed_space
from ..forms.stokes import make_stokes_kernel
from ..mesh.structured import duct_mesh
from ..solve.driver import refine_newton_bcsr, solve_linear_bcsr
from ..solve.refine import refine_enabled
from ..utils.exact import square_duct_mean, square_duct_profile


@dataclasses.dataclass
class DuctResult:
    mesh: object
    space: object
    u: np.ndarray
    p: np.ndarray
    ksp_iters: int
    converged: bool
    refined: bool = False
    refine_resnorm: float = float("nan")

    def flux(self, marker: int) -> float:
        """Integral of u_x over the facets with the given marker."""
        f = self.mesh.facets[self.mesh.facet_markers == marker]
        tp = self.mesh.points[f]
        ar = np.linalg.norm(
            np.cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]) / 2, axis=1)
        return float((self.u[f, 0].mean(axis=1) * ar).sum())


def duct_bcs(mesh, W: MixedVelocityPressureSpace,
             inlet: str = "poiseuille") -> DirichletBC:
    """No-slip walls (marker 4), inlet velocity (marker 1), outlet
    pressure 0 (marker 3).  inlet: 'poiseuille' (exact developed profile,
    mean normalized to 1) or 'uniform' (u_x = 1, the reference's BC,
    DuctStokesFlow.py:171-181)."""
    wall = mesh.nodes_with_marker(4)
    inlet_nodes = mesh.nodes_with_marker(1)
    outlet_nodes = mesh.nodes_with_marker(3)

    def vdofs(nodes):
        return np.stack(
            [W.velocity_dof(nodes, c) for c in range(3)], -1).ravel()

    iv = np.zeros((len(inlet_nodes), 3))
    if inlet == "uniform":
        iv[:, 0] = 1.0
    else:
        yz = mesh.points[inlet_nodes][:, 1:3]
        iv[:, 0] = square_duct_profile(yz[:, 0], yz[:, 1]) / square_duct_mean()

    return combine_bcs([
        DirichletBC(vdofs(wall), np.zeros(3 * len(wall))),
        DirichletBC(vdofs(inlet_nodes), iv.ravel()),
        DirichletBC(W.pressure_dof(outlet_nodes), np.zeros(len(outlet_nodes))),
    ])


def solve_duct(
    n_cross: int = 8,
    n_axial: int = 16,
    length: float = 2.0,
    inlet: str = "poiseuille",
    solver: Optional[SolverConfig] = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> DuctResult:
    """Stokes in the duct to the reference's f64 tolerance (bcgs 1e-10,
    StokesFlow/StokesChannelFlow.py:166), FGMRES + node-block Jacobi."""
    cfg = solver or SolverConfig()
    dtype = default_dtype() if dtype is None else dtype
    mesh = duct_mesh(n_cross, n_axial, length)
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, dtype=dtype, device=device)
    bc = duct_bcs(mesh, W, inlet)
    mask = asm.vector(bc_mask(W.ndofs, bc))
    g64 = torch.as_tensor(bc_vector(W.ndofs, bc), dtype=torch.float64,
                          device=asm.device)
    g = g64.to(dtype)
    pat = asm.pattern

    kern = make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2)
    refine_on = refine_enabled(cfg.refine, dtype)
    # on f32 a 1e-10 Krylov tolerance is out of reach: solve loosely and
    # let refinement carry the residual the rest of the way
    res = solve_linear_bcsr(
        kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
        1e-6 if refine_on else 1e-10, cfg.ksp_restart, asm.arrays, mask, g)

    if refine_on:
        zero = torch.zeros_like(mask)
        n0 = float(torch.linalg.vector_norm(
            asm.bc_residual(kern, zero, mask, g)))
        rres = refine_newton_bcsr(
            kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays,
            asm_arrays_in(asm.arrays, mesh, torch.float64), mask, g64,
            res.x, n0, 1e-10, 0.0, cfg.refine_max_it, cfg.refine_ksp_rtol,
            cfg.ksp_restart, cfg.refine_ksp_max_restarts)
        u, p = W.split(rres.x.cpu().numpy())
        return DuctResult(mesh, W, u, p, int(res.iters), rres.converged,
                          refined=True, refine_resnorm=rres.resnorm)

    u, p = W.split(res.x.cpu().numpy())
    return DuctResult(mesh, W, u, p, int(res.iters), bool(res.converged))


def main(argv=None, device=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    r = solve_duct(n, 2 * n, device=device)
    print(f"KSP iters: {r.ksp_iters}, converged: {r.converged}")
    print(f"inlet flux {r.flux(1):.6f}  outlet flux {r.flux(3):.6f}")
    pts = r.mesh.points
    uex = square_duct_profile(pts[:, 1], pts[:, 2]) / square_duct_mean()
    err = np.sqrt(np.mean((r.u[:, 0] - uex) ** 2)) / np.sqrt(np.mean(uex**2))
    print(f"relative L2 error vs developed profile: {err:.4f}")
    return r


if __name__ == "__main__":
    main()
