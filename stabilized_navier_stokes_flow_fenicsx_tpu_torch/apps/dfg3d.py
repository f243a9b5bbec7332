"""DFG 3D pillar benchmark (3D-1Z, Re=20).

Counterpart of the JAX package's ``apps/dfg3d.py``; both solves run on
the card (``device="cpu"`` runs them on the CPU).  Replicates reference
NavierStokes/Validation_Flow/DFG_3D_Validation.py:
channel [0,2.2]x[0,0.41]x[0,0.41] with a circular pillar (c=(0.5,0.2),
r=0.05) extruded through the span (dfg_pillar_3D.geo:33-36,96);
bi-parabolic inlet u_x = 0.45 * 16 y z (0.41-y)(0.41-z)/0.41^4 (:103-106);
Stokes init -> G-metric SUPS Navier-Stokes at nu = 1e-3 (:193);
drag/lift from the traction integral sigma.(-n) over the pillar with
C = 2F/(rho Uc^2 Lc), Uc = 0.2, Lc = 0.041 (:344-367).

Markers: 2 = inlet, 3 = outlet, 4 = walls (incl. z-planes), 5 = obstacle.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..assemble.assembly import ASM_CHUNK, assembler_for_mixed
from ..config import SolverConfig
from ..fem.bc import DirichletBC, bc_mask, bc_vector, combine_bcs
from ..fem.space import make_mixed_space
from ..flow.forces import (
    facet_owners, reaction_force, reaction_from_residual, traction_force_3d)
from ..forms.navier_stokes import make_ns_sups_kernel
from ..forms.stokes import make_stokes_kernel
from ..mesh.core import SimplexMesh, mark_boundary_facets
from ..mesh.extrude import extrude_tri_mesh
from ..mesh.sizefield import (
    merge_meshes, structured_annulus, triangulate_sizefield)
from ..solve.newton_host import linear_host_lu, newton_host_lu
from ..utils.profiling import count, read, span

L, W = 2.2, 0.41
CX, CY, R = 0.5, 0.2, 0.05
UM = 0.45                          # inflow peak (:103-106)
NU = 1e-3
UC, LC_REF = 0.2, 0.1 * 0.41
# the layered solve's viscosity ladder from rest, and each rung's Newton
# and FGMRES settings (the last rung runs to NEWTON_ATOL_LAST)
NU_LADDER = (1e-1, 1e-2, 3e-3, NU)
NEWTON_RTOL, NEWTON_ATOL, NEWTON_ATOL_LAST = 1e-8, 1e-9, 1e-10
NEWTON_MAX_IT = 30
KSP_RESTART, KSP_MAX_RESTARTS = 50, 40
# cells one call of the plain SoA Jacobian or residual takes on the
# layered route, at most: four times the channel's ASM_CHUNK, or the whole
# mesh where it is smaller (a plan pads its cells to whole chunks).  On
# the card K4 takes the whole mesh in one launch, and the chunk sets only
# the plan's column padding.
ASM_CHUNK_CELLS = 4 * ASM_CHUNK


def dfg3d_mesh(scale: float = 1.0, cyl_factor: float = 1.0,
               symmetric_band: bool = True,
               near_growth: float = 0.3) -> SimplexMesh:
    """cyl_factor < 1 refines the pillar neighbourhood only (the drag
    error is dominated by the surface/boundary-layer resolution);
    symmetric_band glues a structured annulus into the cross-section
    (see dfg2d / mesh/sizefield.py) before extruding through the span;
    near_growth sets the in-plane size growth off the pillar (the 2D
    lift-accuracy axis, apps/dfg2d.py — the 3D default stays 0.3
    because every in-plane cell is extruded through the whole span)."""
    lc_far = 0.09 * scale
    lc_wake = 0.035 * scale
    lc_cyl = 0.014 * scale * cyl_factor

    def lc_fn(p):
        p = np.atleast_2d(p)
        d = np.hypot(p[:, 0] - CX, p[:, 1] - CY) - R
        near = lc_cyl + near_growth * np.maximum(d, 0.0)
        wake = np.where(
            (p[:, 0] > CX) & (p[:, 0] < 1.4) & (np.abs(p[:, 1] - CY) < 0.15),
            lc_wake, lc_far)
        return np.minimum(near, wake)

    rect = np.array([[0, 0], [L, 0], [L, W], [0, W]], dtype=float)
    center = np.array([CX, CY])
    if symmetric_band:
        apts, atris, _inner, outer_ids = structured_annulus(
            center, R, lc_cyl, n_layers=3)
        ann = SimplexMesh("triangle", apts, atris).orient_positive()
        tri = triangulate_sizefield(
            rect, [], lc_fn, lc_min=lc_cyl,
            fixed_hole_loops=[apts[outer_ids]])
        tri = merge_meshes(tri, ann)
    else:
        th = np.linspace(0, 2 * np.pi, 128, endpoint=False)
        circle = np.stack(
            [CX + R * np.cos(th), CY + R * np.sin(th)], axis=1)
        tri = triangulate_sizefield(rect, [circle], lc_fn, lc_min=lc_cyl)
    # span resolution follows the UNSCALED cylinder lc (the z-direction
    # needs no extra refinement when cyl_factor shrinks in-plane cells)
    n_layers = max(4, int(np.ceil(W / (2.5 * 0.014 * scale))))
    msh = extrude_tri_mesh(tri, np.linspace(0.0, W, n_layers + 1))
    eps = 1e-9

    def on_pillar(p):
        return np.hypot(p[:, 0] - CX, p[:, 1] - CY) < R + 0.25 * lc_cyl

    mark_boundary_facets(msh, {
        2: lambda p: p[:, 0] < eps,
        3: lambda p: p[:, 0] > L - eps,
        5: on_pillar,
    }, default=4)
    return msh


@dataclasses.dataclass
class DFG3DResult:
    mesh: SimplexMesh
    u: np.ndarray
    p: np.ndarray
    cd: float                    # consistent reaction-force evaluation
    cl: float
    newton_iters: int
    converged: bool
    cd_surface: float = float("nan")   # reference traction integral
    cl_surface: float = float("nan")
    # solve_dfg3d_fine only: per viscosity rung (nu, Newton steps, FGMRES
    # iterations per step, |F|, wall seconds)
    rungs: list = dataclasses.field(default_factory=list)


def _pillar_bcs(mesh: SimplexMesh, Wsp):
    """(bc, obstacle nodes): bi-parabolic inlet (marker 2), no-slip walls
    (4) and pillar (5); no pressure Dirichlet (do-nothing outlet)."""
    inlet = mesh.nodes_with_marker(2)
    walls = mesh.nodes_with_marker(4)
    obst = mesh.nodes_with_marker(5)

    def vdofs(nodes):
        return np.stack(
            [Wsp.velocity_dof(nodes, c) for c in range(3)], -1).ravel()

    iv = np.zeros((len(inlet), 3))
    y, z = mesh.points[inlet, 1], mesh.points[inlet, 2]
    iv[:, 0] = (4 * y * (W - y) / W**2) * (4 * z * (W - z) / W**2) * UM
    bc = combine_bcs([
        DirichletBC(vdofs(inlet), iv.ravel()),
        DirichletBC(vdofs(walls), np.zeros(3 * len(walls))),
        DirichletBC(vdofs(obst), np.zeros(3 * len(obst))),
    ])
    return bc, obst


def _coefficients(F) -> tuple:
    """(Cd, Cl) of a force: C = 2 F / (rho Uc^2 Lc)."""
    return (float(2 * F[0] / (UC**2 * LC_REF)),
            float(2 * F[1] / (UC**2 * LC_REF)))


@dataclasses.dataclass
class DFG3DProblem:
    """The layered problem of DFG 3D-1Z, built once by ``setup_dfg3d``
    and solved from rest by ``solve_dfg3d_from_rest`` as often as asked.
    Tensors in ``dtype`` on ``device`` (the hierarchy's values take the
    pc's own type)."""

    mesh: SimplexMesh
    space: object                # fem.space.MixedVelocityPressureSpace
    lp: object                   # assemble.layered.LayeredPattern
    mask: torch.Tensor
    g: torch.Tensor
    hier: object                 # solve.mg.build_mg_hierarchy's result
    obst: np.ndarray             # pillar nodes (marker 5)
    obst_dofs: torch.Tensor      # (3, n_obst) their velocity dofs
    obst_owners: np.ndarray      # the owner cell of each pillar facet


def setup_dfg3d(scale: float = 0.5, cyl_factor: float = 1.0,
                near_growth: float = 0.15, mg_levels: int = 3,
                dtype: Optional[torch.dtype] = None,
                device=None) -> DFG3DProblem:
    """The problem of ``solve_dfg3d_fine``: mesh, mixed space, layered
    pattern, pillar BCs, mask, g and the multigrid hierarchy, in
    ``dtype`` (float64 when None) on ``device`` (the card when None);
    one ``dfg3d.setup`` span around ``mesh``, ``build_layered`` and
    ``mg_hierarchy``."""
    from ..assemble.layered import build_layered
    from ..config import default_device, default_dtype
    from ..solve.mg import build_mg_hierarchy

    device = default_device() if device is None else torch.device(device)
    dtype = default_dtype() if dtype is None else dtype
    with span("dfg3d.setup"):
        with span("mesh"):
            mesh = dfg3d_mesh(scale, cyl_factor=cyl_factor,
                              near_growth=near_growth)
        Wsp = make_mixed_space(mesh, 1, 1)
        np2, Lp, _used = mesh.layered
        lp = build_layered(Wsp, np2, Lp, dtype, device,
                           chunk_cells=min(ASM_CHUNK_CELLS, mesh.n_cells))
        bc, obst = _pillar_bcs(mesh, Wsp)
        mask_np = bc_mask(Wsp.ndofs, bc)
        mask = torch.as_tensor(mask_np, dtype=dtype, device=device)
        g = torch.as_tensor(bc_vector(Wsp.ndofs, bc), dtype=dtype,
                            device=device)
        hier = build_mg_hierarchy(
            lp.rows2d, lp.cols2d, lp.n2d, lp.n_planes,
            mask_np.astype(np.float32), lp.bs, n_levels=mg_levels,
            device=device)
        obst_dofs = torch.as_tensor(
            np.stack([Wsp.velocity_dof(obst, c) for c in range(3)]),
            dtype=torch.int64, device=device)
        owners = facet_owners(mesh, mesh.facets_with_marker(5))
    return DFG3DProblem(mesh, Wsp, lp, mask, g, hier, obst, obst_dofs,
                        owners)


def _fine_setup(scale, cyl_factor, near_growth, mg_levels, device):
    """``setup_dfg3d``'s float64 problem as the tuple (mesh, space,
    layered pattern, mask, g, multigrid hierarchy, obstacle nodes)."""
    p = setup_dfg3d(scale, cyl_factor, near_growth, mg_levels,
                    device=device)
    return p.mesh, p.space, p.lp, p.mask, p.g, p.hier, p.obst


def solve_dfg3d_from_rest(prob: DFG3DProblem, ladder=NU_LADDER,
                          ksp_rtol: float = 1e-5,
                          pc: str = "mg_cheby6_bf16") -> DFG3DResult:
    """One solve of ``prob`` from rest (x = g) through the viscosity
    ``ladder``, then the forces, inside a ``case`` span: ``continuation``
    > ``rung`` (one per viscosity; the counters ``rung_newton_steps``
    and ``rung_krylov_its`` keyed by it), the one read of the served
    state, ``forces`` > ``reaction``, ``traction``.

    Each rung is ``solve_newton_layered`` in the problem's dtype (rtol
    1e-8, atol 1e-9; the last rung to atol 1e-10), FGMRES (restart 50,
    40 restarts) preconditioned by ``pc``, on the textbook SUPS residual
    (see ``solve_dfg3d``'s transposed_stab note); ``converged`` is the
    last rung's flag.  Cd and Cl come from the consistent reaction
    functional of the RAW layered residual (no BC substitution, no
    projection) at the last viscosity, summed on the device; the
    reference's traction surface integral is kept for parity."""
    from ..assemble.layered import residual_layered
    from ..solve.driver import solve_newton_layered

    lp = prob.lp
    with span("case"):
        with span("continuation"):
            x = prob.g
            rungs = []
            for nu_step in ladder:
                ns_k = make_ns_sups_kernel("tetrahedron", nu=nu_step,
                                           transposed_stab=False)
                last = nu_step == ladder[-1]
                with span("rung") as s:
                    nres = solve_newton_layered(
                        ns_k, lp.n2d, lp.n_planes, lp.bs, lp.arrays,
                        prob.mask, prob.g, x, lp.E, rtol=NEWTON_RTOL,
                        atol=NEWTON_ATOL_LAST if last else NEWTON_ATOL,
                        max_it=NEWTON_MAX_IT, ksp_rtol=ksp_rtol,
                        ksp_restart=KSP_RESTART,
                        ksp_max_restarts=KSP_MAX_RESTARTS, pc=pc,
                        mg=prob.hier)
                x = nres.x
                ksp = [int(k) for k in nres.history[:, 2]]
                count("rung_newton_steps", int(nres.iters), key=nu_step)
                count("rung_krylov_its", sum(ksp), key=nu_step)
                rungs.append((nu_step, int(nres.iters), ksp,
                              float(nres.resnorm), s.seconds))
        u, p = prob.space.split(read(x, torch.Tensor.cpu).double().numpy())
        with span("forces"):
            with span("reaction"):
                r = residual_layered(ns_k, lp.n2d, lp.n_planes, lp.bs,
                                     lp.arrays, x)
                cd, cl = _coefficients(reaction_from_residual(
                    r, prob.obst_dofs))
            cd_s, cl_s = _coefficients(-traction_force_3d(
                prob.mesh, u, p, 5, ladder[-1], owners=prob.obst_owners))
    return DFG3DResult(prob.mesh, u, p, cd, cl, int(nres.iters),
                       bool(nres.converged), cd_s, cl_s, rungs)


def solve_dfg3d_fine(scale: float = 0.5,
                     cyl_factor: float = 1.0,
                     near_growth: float = 0.15,
                     ksp_rtol: float = 1e-5,
                     pc: str = "mg_cheby6_bf16",
                     mg_levels: int = 3,
                     device=None) -> DFG3DResult:
    """DFG 3D-1Z on the layered path, for meshes beyond the host LU's
    reach (validate the 3D lift at a mesh where the 0.15%-of-drag signal
    clears the discretization noise floor): ``setup_dfg3d`` in float64,
    then ``solve_dfg3d_from_rest``, with a progress line for the set-up,
    each rung and the forces.

    The pillar mesh is a z-extrusion with plane-major node ids
    (mesh/extrude.py::extrude_tri_mesh), which is exactly the contract
    of the layered operator (assemble/layered.py) — the extrusion axis
    never enters the pattern build, so the whole channel fast path
    (plane-structured assembly, the layered SpMV kernel, the
    mg-Chebyshev V-cycle, FGMRES Newton) applies verbatim, in float64.

    DELIBERATE differences from the JAX package: its stepped Newton
    drivers are a work-around for its remote compiler and are not
    ported, and it solves in float32 with a double-float refinement pass
    because its device lacks float64.  Here every viscosity rung is
    ``solve_newton_layered`` in float64 (rtol 1e-8, atol 1e-9), and the
    last rung runs to the refinement's own targets (rtol 1e-8, atol
    1e-10) with no refinement pass.
    """
    t_all = time.time()
    prob = setup_dfg3d(scale, cyl_factor, near_growth, mg_levels,
                       device=device)
    lp = prob.lp
    print(f"dfg3d_fine: {len(prob.mesh.points)} nodes, "
          f"{prob.mesh.n_cells} tets, {prob.space.ndofs} dofs, "
          f"n2d={lp.n2d} Lp={lp.n_planes} "
          f"(setup {time.time() - t_all:.1f}s)", flush=True)
    r = solve_dfg3d_from_rest(prob, ksp_rtol=ksp_rtol, pc=pc)
    for nu_step, its, _ksp, fnorm, wall in r.rungs:
        print(f"dfg3d_fine: nu={nu_step} its={its} |F|={fnorm:.3e} "
              f"({wall:.1f}s)", flush=True)
    print(f"dfg3d_fine: Cd={r.cd:.5f} Cl={r.cl:.6f} "
          f"(surface Cd={r.cd_surface:.5f} Cl={r.cl_surface:.6f}) "
          f"total {time.time() - t_all:.1f}s", flush=True)
    return r


def solve_dfg3d(scale: float = 1.0,
                solver: Optional[SolverConfig] = None,
                device=None, **mesh_kwargs) -> DFG3DResult:
    """DFG 3D-1Z with device assembly and host-LU Newton updates
    (solve/newton_host.py); tops out near ~30k nodes."""
    cfg = solver or SolverConfig()
    mesh = dfg3d_mesh(scale, **mesh_kwargs)
    Wsp = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(Wsp, device=device)

    bc, _obst = _pillar_bcs(mesh, Wsp)
    mask = bc_mask(Wsp.ndofs, bc)
    g = bc_vector(Wsp.ndofs, bc)

    stokes_k = make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2)
    x = linear_host_lu(asm, stokes_k, mask, g)

    # transposed_stab=False: the textbook SUPS residual (u.grad)u, not the
    # reference's UFL dot(u, grad(u)) quirk ((grad u)^T u).  The quirk
    # residual is inconsistent (nonzero at the exact solution), which
    # poisons the consistent reaction-force functional: measured Cd
    # DIVERGES 7.27 -> 7.54 -> 8.03 under refinement with the quirk, and
    # converges with the textbook form.  The production channel solver
    # keeps the quirk behind its flag for field parity; validation apps
    # validate physics.
    for nu_step in (1e-1, 1e-2, 3e-3, NU):
        ns_k = make_ns_sups_kernel("tetrahedron", nu=nu_step,
                                   transposed_stab=False)
        nres = newton_host_lu(asm, ns_k, mask, g, x,
                              rtol=1e-8, atol=1e-9,
                              max_it=cfg.newton_max_it)
        x = nres.x

    w = nres.x
    u, p = Wsp.split(w)
    # consistent reaction force (superconvergent; see flow/forces.py)
    cd, cl = _coefficients(reaction_force(asm, ns_k, Wsp, mesh, w, 5))
    # the reference's traction surface integral, kept for parity
    cd_s, cl_s = _coefficients(-traction_force_3d(mesh, u, p, 5, NU))
    return DFG3DResult(mesh, u, p, cd, cl,
                       int(nres.iters), bool(nres.converged),
                       cd_surface=cd_s, cl_surface=cl_s)


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    scale = float(argv[0]) if argv else 1.5
    r = solve_dfg3d(scale, device=device)
    print(f"Velocity Degrees of Freedom: {3 * r.mesh.n_nodes}")
    print(f"Coefficient of Lift: {r.cl}")
    print(f"Coefficient of Drag: {r.cd}")
    return r


if __name__ == "__main__":
    main()
