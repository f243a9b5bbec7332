"""Square-duct Stokes with Taylor-Hood P2-P1 (the reference's element pair).

Counterpart of the JAX package's ``apps/duct_stokes_th.py``; runs on the
card (``device="cpu"`` runs it on the CPU).

    python -m \
      stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.duct_stokes_th [n]

Reference StokesFlow/DuctStokesFlow.py: TH mixed space (:147-154), uniform
inlet u=(1,0,0) (:171-181), no-slip walls, do-nothing outlet, direct
MUMPS solve with null-pivot ICNTL handling (:213-216: the inlet-rim
pressure vertices whose coupled velocity dofs are all constrained; the
host LU pins them to zero, the Schur solve leaves them undetermined and
runs to its iteration limit on their rows while every other dof
converges), L1/Linf norm printouts (:233-241).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..assemble.assembly import assembler_for_mixed
from ..fem.bc import DirichletBC, bc_mask, bc_vector, combine_bcs
from ..fem.space import make_mixed_space
from ..forms.stokes_th import make_stokes_th_kernel
from ..mesh.structured import duct_mesh
from ..solve.newton_host import linear_host_lu
from ..utils.exact import square_duct_mean, square_duct_profile


@dataclasses.dataclass
class DuctTHResult:
    mesh: object
    space: object
    u: np.ndarray            # (n_scalar_v, 3) at P2 dof points
    p: np.ndarray            # (n_nodes,)
    u_coords: np.ndarray     # P2 dof coordinates
    outer_iters: int = 0     # FGMRES iterations (method="schur")
    inner_iters: int = 0     # total Jacobi-CG steps of the velocity block


def solve_duct_th(n_cross: int = 6, n_axial: int = 12, length: float = 2.0,
                  inlet: str = "uniform", method: str = "schur",
                  rtol: float = 1e-10, device=None) -> DuctTHResult:
    """method='schur': fieldsplit-preconditioned FGMRES on the symmetric
    saddle point, every vector on the device (solve/stokes_th.py;
    reference MUMPS: StokesFlow/DuctStokesFlow.py:213-216).
    method='lu': device assembly + host SuperLU (kept as the oracle)."""
    mesh = duct_mesh(n_cross, n_axial, length)
    W = make_mixed_space(mesh, 2, 1)          # Taylor-Hood
    asm = assembler_for_mixed(W, device=device)

    # facet-supported velocity dofs include edge midpoints (P2)
    wall_facets = mesh.facets_with_marker(4)
    inlet_facets = mesh.facets_with_marker(1)
    vd_wall = W.velocity_dofs_on_facets(wall_facets)
    sd_inlet = W.V.scalar_dofs_on_nodes(
        np.unique(inlet_facets.ravel()))
    if inlet == "uniform":
        vals = np.zeros((len(sd_inlet), 3))
        vals[:, 0] = 1.0
    else:
        yz = W.V.dof_coords[sd_inlet][:, 1:3]
        vals = np.zeros((len(sd_inlet), 3))
        vals[:, 0] = square_duct_profile(yz[:, 0], yz[:, 1]) \
            / square_duct_mean()
    vd_inlet = np.stack(
        [W.velocity_dof(sd_inlet, c) for c in range(3)], -1).ravel()

    # NO pressure Dirichlet: the do-nothing outlet (free outlet velocity)
    # fixes the pressure level naturally, exactly like the reference's
    # formulation (DuctStokesFlow.py:156-183 constrains velocity only).
    # Constraining a whole plane of pressures deletes those continuity
    # equations and makes the saddle point singular (measured: one zero
    # Schur eigenvalue and a 3e-3 residual floor even for direct LU).
    bc = combine_bcs([
        DirichletBC(vd_wall, np.zeros(len(vd_wall))),
        DirichletBC(vd_inlet, vals.ravel()),
    ])
    outer = inner = 0
    if method == "lu":
        kern = make_stokes_th_kernel("tetrahedron", nu=1.0)
        x = linear_host_lu(asm, kern, bc_mask(W.ndofs, bc),
                           bc_vector(W.ndofs, bc))
    else:
        from ..solve.stokes_th import solve_th_schur
        from ..utils.linalg import det_small

        kern = make_stokes_th_kernel(
            "tetrahedron", nu=1.0, symmetric_signs=True)
        values, _A_bc, b_bc, mask_ = asm.linear_system(kern, bc)
        # velocity-component indicator + lumped P1 pressure mass
        mv = np.ones(W.ndofs)
        pd = np.asarray(W.pressure_dof(np.arange(mesh.n_nodes)))
        mv[pd] = 0.0
        coords = mesh.points[mesh.cells]
        E = coords[:, 1:, :] - coords[:, :1, :]
        vol = np.abs(det_small(torch.as_tensor(
            np.transpose(E, (0, 2, 1)))).numpy()) / 6.0
        m_lump = np.zeros(mesh.n_nodes)
        np.add.at(m_lump, mesh.cells.ravel(), np.repeat(vol / 4.0, 4))
        mp_diag = np.zeros(W.ndofs)
        mp_diag[pd] = m_lump
        res = solve_th_schur(
            asm.ndofs, asm.pattern.n_rows, asm.arrays, values, b_bc,
            mask_, asm.vector(mv), asm.vector(mp_diag), rtol=rtol)
        x = res.x.cpu().numpy()
        outer, inner = res.outer_iters, res.inner_iters
    u, p = W.split(x)
    return DuctTHResult(mesh, W, u, p, W.V.dof_coords, outer, inner)


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 6
    r = solve_duct_th(n, 2 * n, device=device)
    u_flat = r.u.reshape(-1)
    print(f"L1 norm of velocity coefficient vector: "
          f"{np.abs(u_flat).sum():.6e}")
    print(f"L1 norm of pressure coefficient vector: "
          f"{np.abs(r.p).sum():.6e}")
    print(f"Linf norm of velocity coefficient vector: "
          f"{np.abs(u_flat).max():.6e}")
    print(f"Linf norm of pressure coefficient vector: "
          f"{np.abs(r.p).max():.6e}")
    return r


if __name__ == "__main__":
    main()
