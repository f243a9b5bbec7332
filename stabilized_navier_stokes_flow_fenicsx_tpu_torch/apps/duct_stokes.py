"""Square-duct Stokes flow — the reference's known-output smoke test.

Counterpart of the JAX package's ``apps/duct_stokes.py``, reimplementing
reference StokesFlow/DuctStokesFlow.py: a square duct x in [0, L],
cross-section (-0.5, 0.5)^2, inlet velocity Dirichlet, no-slip walls,
outlet pressure 0 (reference :156-183).  The duct is a native structured
tet mesh solved with the stabilized P1-P1 form + FGMRES on the block-CSR
path; for exact-profile inflow the solution must stay fully developed
(README.md:44-56).  The solve runs on the card (``device="cpu"`` runs it
on the CPU).

DELIBERATE difference: the JAX package's double-float refinement branch
(taken on float32) is not ported.  The port solves in float64, where
``refine="auto"`` is off; ``refine="on"`` raises NotImplementedError.

    python -m stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.duct_stokes [n]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..assemble.assembly import assembler_for_mixed
from ..config import SolverConfig
from ..fem.bc import DirichletBC, bc_mask, bc_vector, combine_bcs
from ..fem.space import MixedVelocityPressureSpace, make_mixed_space
from ..forms.stokes import make_stokes_kernel
from ..mesh.structured import duct_mesh
from ..solve.driver import solve_linear_bcsr
from ..utils.exact import square_duct_mean, square_duct_profile


@dataclasses.dataclass
class DuctResult:
    mesh: object
    space: object
    u: np.ndarray
    p: np.ndarray
    ksp_iters: int
    converged: bool

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
    device=None,
) -> DuctResult:
    """Stokes in the duct to the reference's f64 tolerance (bcgs 1e-10,
    StokesFlow/StokesChannelFlow.py:166), FGMRES + node-block Jacobi."""
    cfg = solver or SolverConfig()
    if cfg.refine == "on":
        raise NotImplementedError(
            "double-float refinement is not ported: solve in float64")
    mesh = duct_mesh(n_cross, n_axial, length)
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, device=device)
    bc = duct_bcs(mesh, W, inlet)
    mask = asm.vector(bc_mask(W.ndofs, bc))
    g = asm.vector(bc_vector(W.ndofs, bc))
    pat = asm.pattern

    kern = make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2)
    res = solve_linear_bcsr(
        kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
        1e-10, cfg.ksp_restart, asm.arrays, mask, g)
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
