"""DFG 2D-1 cylinder benchmark (Schaefer-Turek Re=20).

Counterpart of the JAX package's ``apps/dfg2d.py``: assembly on the card
(``device="cpu"`` runs it on the CPU), the Newton updates by host SuperLU
(solve/newton_host.py).  Replicates reference
NavierStokes/Validation_Flow/DFG_2D_Validation.py:
channel [0,2.2]x[0,0.41] with a cylinder (c=(0.2,0.2), r=0.05); parabolic
inlet 4*0.3*y*(0.41-y)/0.41^2 (:52-55); stabilized P1-P1 Stokes init
(mu_T = 0.2 h^2) -> UGN-stabilized NS Newton at nu = 1e-3; drag/lift via
the tangential-gradient surface integral with the literature references
Cd = 5.57953523384, Cl = 0.010618948146 (:202-203).

The gmsh .geo mesh (dfg_pillar_2D.geo) is replaced by the native
size-field mesher with the same refinement intent: fine at the cylinder,
medium in the wake, coarse far field.

Markers: 2 = inlet, 3 = outlet, 4 = walls, 5 = obstacle (reference :58-62).
NOTE (parity): like the reference, no pressure Dirichlet BC — the
stabilized form plus the do-nothing outlet fixes the pressure level.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np

from ..assemble.assembly import assembler_for_mixed
from ..config import SolverConfig
from ..fem.bc import DirichletBC, bc_mask, bc_vector, combine_bcs
from ..fem.space import make_mixed_space
from ..flow.forces import dfg_2d_coefficients, reaction_force
from ..forms.navier_stokes import make_ns_ugn_kernel
from ..forms.stokes import make_stokes_kernel
from ..mesh.core import SimplexMesh, mark_boundary_facets
from ..mesh.sizefield import (
    boundary_layer_rings, merge_meshes, structured_annulus,
    triangulate_sizefield)
from ..solve.newton_host import linear_host_lu, newton_host_lu

CD_REF = 5.57953523384
CL_REF = 0.010618948146

L, W = 2.2, 0.41
CX, CY, R = 0.2, 0.2, 0.05
NU = 1e-3


def dfg2d_mesh(scale: float = 1.0, cyl_factor: float = 0.5,
               symmetric_band: bool = True, band_layers: int = 5,
               band_first: float = 0.35,
               band_ratio: float = 1.4,
               wake_factor: float = 1.0,
               near_growth: float = 0.05) -> SimplexMesh:
    """Graded cylinder-channel mesh; scale < 1 refines everything,
    cyl_factor < 1 refines the cylinder neighbourhood only (the lift
    coefficient is 0.2% of drag and needs the boundary layer resolved),
    wake_factor < 1 refines the wake/far field only, near_growth sets
    the size-field growth rate off the cylinder wall.

    near_growth is THE lift accuracy axis (measured sweep): the pressure
    field in the O(R) shell around the cylinder carries the lift signal,
    and growth 0.25 starves it.  Measured Cl error at cyl_factor=0.5:
    growth 0.25 -> -24%..-21% across scales 0.5..0.25 (plateaued);
    growth 0.05 -> +0.4% / +1.6% / +0.7% / +0.2% at scales
    0.7/0.5/0.35/0.25, with FEWER nodes than scale reduction ever
    reached (wake-only refinement moved nothing: -22.1%).  Cd
    simultaneously lands at -0.2% everywhere.

    symmetric_band: replace the Delaunay boundary-layer rings with a
    structured annulus that is exactly mirror-symmetric about y = CY
    (see mesh/sizefield.py structured_annulus) — on quasi-random meshes
    the mesh-asymmetry error near the cylinder swamps the tiny lift
    (measured -44%..+220% oscillation across scales)."""
    lc_far = 0.08 * scale * wake_factor
    lc_wake = 0.02 * scale * wake_factor
    lc_cyl = 0.006 * scale * cyl_factor

    def lc_fn(p):
        p = np.atleast_2d(p)
        d = np.hypot(p[:, 0] - CX, p[:, 1] - CY) - R
        near = lc_cyl + near_growth * np.maximum(d, 0.0)
        wake = np.where(
            (p[:, 0] > CX) & (p[:, 0] < 1.2) & (np.abs(p[:, 1] - CY) < 0.15),
            lc_wake, lc_far)
        return np.minimum(near, wake)

    rect = np.array([[0, 0], [L, 0], [L, W], [0, W]], dtype=float)
    center = np.array([CX, CY])
    if symmetric_band:
        apts, atris, _inner, outer_ids = structured_annulus(
            center, R, lc_cyl, n_layers=band_layers, first=band_first,
            ratio=band_ratio)
        ann = SimplexMesh("triangle", apts, atris).orient_positive()
        far = triangulate_sizefield(
            rect, [], lc_fn, lc_min=lc_cyl,
            fixed_hole_loops=[apts[outer_ids]])
        msh = merge_meshes(far, ann)
    else:
        th = np.linspace(0, 2 * np.pi, 256, endpoint=False)
        circle = np.stack(
            [CX + R * np.cos(th), CY + R * np.sin(th)], axis=1)
        rings = boundary_layer_rings(center, R, lc_cyl)
        msh = triangulate_sizefield(rect, [circle], lc_fn, lc_min=lc_cyl,
                                    extra_points=rings)
    eps = 1e-9

    def on_circle(p):
        return np.hypot(p[:, 0] - CX, p[:, 1] - CY) < R + 0.25 * lc_cyl

    mark_boundary_facets(msh, {
        2: lambda p: p[:, 0] < eps,
        3: lambda p: p[:, 0] > L - eps,
        5: on_circle,
    }, default=4)
    return msh


@dataclasses.dataclass
class DFG2DResult:
    mesh: SimplexMesh
    u: np.ndarray
    p: np.ndarray
    cd: float                    # consistent reaction-force evaluation
    cl: float
    cd_err_pct: float
    cl_err_pct: float
    newton_iters: int
    converged: bool
    # the reference's tangential-gradient surface integral (parity)
    cd_surface: float = float("nan")
    cl_surface: float = float("nan")
    # Newton steps per viscosity rung, and the wall split: mesh_s,
    # stokes_s, assembly_s (device, with the copy to the host), index_s
    # (scipy conversion and free-free indexing), lu_s (SuperLU)
    rung_iters: list = dataclasses.field(default_factory=list)
    timings: dict = dataclasses.field(default_factory=dict)


def solve_dfg2d(scale: float = 1.0,
                solver: Optional[SolverConfig] = None,
                cyl_factor: float = 0.5, device=None,
                **mesh_kwargs) -> DFG2DResult:
    cfg = solver or SolverConfig()
    t0 = time.perf_counter()
    mesh = dfg2d_mesh(scale, cyl_factor, **mesh_kwargs)
    timings = {"mesh_s": time.perf_counter() - t0}
    Wsp = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(Wsp, device=device)

    inlet = mesh.nodes_with_marker(2)
    walls = mesh.nodes_with_marker(4)
    obst = mesh.nodes_with_marker(5)

    def vdofs(nodes):
        return np.stack(
            [Wsp.velocity_dof(nodes, c) for c in range(2)], -1).ravel()

    iv = np.zeros((len(inlet), 2))
    y = mesh.points[inlet, 1]
    iv[:, 0] = 4 * 0.3 * y * (W - y) / W**2
    bc = combine_bcs([
        DirichletBC(vdofs(inlet), iv.ravel()),
        DirichletBC(vdofs(walls), np.zeros(2 * len(walls))),
        DirichletBC(vdofs(obst), np.zeros(2 * len(obst))),
    ])
    mask = bc_mask(Wsp.ndofs, bc)
    g = bc_vector(Wsp.ndofs, bc)

    # the reference solves both stages with a direct factorization
    # (preonly+mumps, :115-120 and :169-189) — host SuperLU stands in
    stokes_k = make_stokes_kernel("triangle", nu=1.0, mu_T_coeff=0.2)
    t0 = time.perf_counter()
    x = linear_host_lu(asm, stokes_k, mask, g)
    timings["stokes_s"] = time.perf_counter() - t0

    # viscosity continuation down to nu=1e-3 (the reference's production
    # mesh is fine enough to go straight from Stokes; coarse native meshes
    # need the ladder)
    rung_iters = []
    for nu_step in (1e-1, 1e-2, 3e-3, NU):
        ns_k = make_ns_ugn_kernel("triangle", nu=nu_step)
        nres = newton_host_lu(
            asm, ns_k, mask, g, x,
            rtol=1e-9, atol=1e-10, max_it=cfg.newton_max_it,
            timings=timings)
        x = nres.x
        rung_iters.append(int(nres.iters))

    w = nres.x
    u, p = Wsp.split(w)
    cd_s, cl_s = dfg_2d_coefficients(mesh, u, p, 5, NU)
    # consistent reaction force: superconvergent (~1.5% Cd on these
    # meshes vs ~7% for the surface integral)
    fx, fy = reaction_force(asm, ns_k, Wsp, mesh, w, 5)
    rho_U2_L = 0.1 * 0.2**2
    cd, cl = 2 * fx / rho_U2_L, 2 * fy / rho_U2_L
    return DFG2DResult(
        mesh, u, p, cd, cl,
        100 * (cd - CD_REF) / CD_REF, 100 * (cl - CL_REF) / CL_REF,
        int(nres.iters), bool(nres.converged),
        cd_surface=cd_s, cl_surface=cl_s,
        rung_iters=rung_iters, timings=timings)


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    scale = float(argv[0]) if argv else 1.0
    r = solve_dfg2d(scale, device=device)
    print(f"Pressure Degrees of Freedom: {r.mesh.n_nodes}")
    print(f"Velocity Degrees of Freedom: {2 * r.mesh.n_nodes}")
    print(f"Coefficient of Lift: {r.cl}")
    print(f"Cl Percent Error: {r.cl_err_pct}")
    print(f"Coefficient of Drag: {r.cd}")
    print(f"Cd Percent Error: {r.cd_err_pct}")
    return r


if __name__ == "__main__":
    main()
