"""Lid-driven cavity: stabilized Stokes -> Navier-Stokes (UGN tau).

Counterpart of the JAX package's ``apps/lid_driven.py``, reimplementing
reference LidDrivenFlow/LidDrivenStokesFlow.py and
LidDrivenNavierStokesFlow.py: unit-square triangle mesh, P1-P1 with the
nu-scaled pressure stabilization mu_T = (1/3) h^2/(4 nu) for the Stokes
initializer (:86-99), then the UGN/Tezduyar-stabilized NS form (:119-143)
solved by Newton from the Stokes initial guess (:175), on the block-CSR
path.  The solves run on the card (``device="cpu"`` runs them on the
CPU).  A float32 solve (``dtype=torch.float32``) is followed by iterative
refinement to the Newton tolerances with an f64 residual (``refine``,
solve/refine.py), where the JAX package refines with a double-float one.

BCs (reference :33-78): no-slip on x=0, x=1, y=0; lid u=(1,0) on y=1 (lid
wins at the corners, matching dolfinx set_bc ordering); p=0 pinned at the
(0,0) corner node.

    python -m stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.lid_driven [n] [Re]
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
from ..forms.navier_stokes import make_ns_ugn_kernel
from ..forms.stokes import make_stokes_kernel
from ..mesh.structured import unit_square_tri
from ..solve.driver import (refine_newton_bcsr, solve_linear_bcsr,
                            solve_newton_bcsr)
from ..solve.refine import refine_enabled


@dataclasses.dataclass
class CavityResult:
    mesh: object
    space: MixedVelocityPressureSpace
    w: np.ndarray
    u: np.ndarray
    p: np.ndarray
    newton_iters: int
    newton_resnorm: float
    converged: bool
    # iterative refinement (solve/refine.py), populated when it ran.  When
    # refined, ``converged`` reports the refined solve and the Newton's
    # own flag is ``base_converged``; w + w_lo is the f64 solution
    refined: bool = False
    refine_resnorm: float = float("nan")
    w_lo: Optional[np.ndarray] = None
    base_converged: bool = True


def cavity_bcs(mesh, W: MixedVelocityPressureSpace) -> DirichletBC:
    pts = mesh.points
    eps = 1e-12
    noslip = np.nonzero(
        (np.abs(pts[:, 0]) < eps) | (np.abs(pts[:, 0] - 1) < eps)
        | (np.abs(pts[:, 1]) < eps))[0].astype(np.int32)
    lid = np.nonzero(np.abs(pts[:, 1] - 1) < eps)[0].astype(np.int32)
    corner = int(np.argmin(pts[:, 0] ** 2 + pts[:, 1] ** 2))

    def vdofs(nodes):
        return np.stack(
            [W.velocity_dof(nodes, c) for c in range(W.dim)], -1).ravel()

    lid_vals = np.zeros((len(lid), 2))
    lid_vals[:, 0] = 1.0
    return combine_bcs([
        DirichletBC(vdofs(noslip), np.zeros(2 * len(noslip))),
        DirichletBC(vdofs(lid), lid_vals.ravel()),       # lid wins at corners
        DirichletBC(np.array([W.pressure_dof(np.int32(corner))]),
                    np.zeros(1)),
    ])


def _cavity(n, dtype, device):
    mesh = unit_square_tri(n, n)
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, dtype=dtype, device=device)
    bc = cavity_bcs(mesh, W)
    mask = asm.vector(bc_mask(W.ndofs, bc))
    g64 = torch.as_tensor(bc_vector(W.ndofs, bc), dtype=torch.float64,
                          device=asm.device)
    return mesh, W, asm, mask, g64


def solve_lid_driven_stokes(
    n: int = 32,
    Re: float = 100.0,
    a0: float = 1.0 / 3.0,
    ksp_rtol: float = 1e-10,
    device=None,
):
    """Stokes-only cavity (reference LidDrivenFlow/LidDrivenStokesFlow.py:
    nu-scaled stabilization mu_T = a0 h^2/(4 nu), bcgs rtol/atol 1e-10).

    Returns (mesh, space, u, p)."""
    nu = 1.0 / Re
    mesh, W, asm, mask, g64 = _cavity(n, None, device)
    g = g64.to(asm.dtype)
    pat = asm.pattern
    stokes_k = make_stokes_kernel(
        "triangle", nu=nu, mu_T_coeff=a0, nu_scaled_stab=True)
    res = solve_linear_bcsr(
        stokes_k, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
        ksp_rtol, 50, asm.arrays, mask, g)
    u, p = W.split(res.x.cpu().numpy())
    return mesh, W, u, p


def solve_lid_driven(
    n: int = 32,
    Re: float = 100.0,
    solver: Optional[SolverConfig] = None,
    a0: float = 1.0 / 3.0,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> CavityResult:
    """Full cavity pipeline: mesh -> Stokes init -> Newton NS solve.

    On float32 (``dtype=torch.float32``) the Newton solve is followed by
    iterative refinement with an f64 residual to the reference's 1e-8
    tolerance (``solver.refine``, solve/refine.py)."""
    cfg = solver or SolverConfig()
    dtype = default_dtype() if dtype is None else dtype
    nu = 1.0 / Re
    mesh, W, asm, mask, g64 = _cavity(n, dtype, device)
    g = g64.to(dtype)
    pat = asm.pattern

    stokes_k = make_stokes_kernel(
        "triangle", nu=nu, mu_T_coeff=a0, nu_scaled_stab=True)
    res = solve_linear_bcsr(
        stokes_k, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
        1e-10, cfg.ksp_restart, asm.arrays, mask, g)

    ns_k = make_ns_ugn_kernel("triangle", nu=nu)
    nres = solve_newton_bcsr(
        ns_k, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
        asm.arrays, mask, g, res.x,
        rtol=cfg.newton_rtol, atol=cfg.newton_atol, max_it=cfg.newton_max_it,
        ksp_rtol=cfg.ksp_rtol, ksp_restart=cfg.ksp_restart)

    if refine_enabled(cfg.refine, dtype):
        # n0 at the Newton's start (the Stokes solution), in the solve
        # dtype, as the JAX package takes it
        n0 = float(torch.linalg.vector_norm(
            asm.bc_residual(ns_k, res.x, mask, g)))
        rres = refine_newton_bcsr(
            ns_k, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays,
            asm_arrays_in(asm.arrays, mesh, torch.float64), mask, g64,
            nres.x, n0, cfg.newton_rtol, cfg.newton_atol,
            cfg.refine_max_it, cfg.refine_ksp_rtol, cfg.ksp_restart,
            cfg.refine_ksp_max_restarts)
        w = rres.x_hi.cpu().numpy()
        w_lo = rres.x_lo.cpu().numpy()
        u, p = W.split(w.astype(np.float64) + w_lo)
        return CavityResult(
            mesh, W, w, u, p, int(nres.iters), float(nres.resnorm),
            rres.converged, refined=True, refine_resnorm=rres.resnorm,
            w_lo=w_lo, base_converged=bool(nres.converged))

    w = nres.x.cpu().numpy()
    u, p = W.split(w)
    return CavityResult(mesh, W, w, u, p, int(nres.iters),
                        float(nres.resnorm), bool(nres.converged))


def main(argv=None, device=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 32
    Re = float(argv[1]) if len(argv) > 1 else 100.0
    r = solve_lid_driven(n, Re, device=device)
    print(f"Newton iters: {r.newton_iters}, |F| = {r.newton_resnorm:.3e}, "
          f"converged = {r.converged}")
    print(f"u_x range: [{r.u[:, 0].min():.4f}, {r.u[:, 0].max():.4f}]")
    return r


if __name__ == "__main__":
    main()
