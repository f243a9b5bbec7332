"""Image-defined channel flow: Stokes -> coarse NS -> fine NS continuation.

Counterpart of the JAX package's ``flow/channel.py`` on the layered
route, replicating reference NavierStokesChannelFlow.py:468-549
(solve_NS_flow):

  1. inlet profiles from the image (flow/inlet.py; reference :102-104)
  2. coarse channel mesh (lc = 0.1; reference :515)
  3. P1-P1 mixed space + BCs: no-slip walls (marker 4), inlet Dirichlet
     velocity from the interpolated 2D profiles (markers 1, 2), outlet
     pressure 0 (marker 3) (reference :127-147)
  4. stabilized Stokes solve (mu_T = 0.2 h^2; reference :160-218)
  5. coarse Navier-Stokes Newton solve from the Stokes guess, through a
     short Reynolds ladder above Re = 50
  6. fine mesh at the user lc; coarse solution interpolated as the
     initial guess (non-matching interpolation; reference :175-194)
  7. fine Navier-Stokes Newton solve

``warm=`` (the Reynolds sweep) skips steps 2-6: the fine Newton starts
from a previous Re's fine solution on the same (image, lc).

Meshing, BCs and interpolation are host numpy; every solve runs on the
given torch device.  The Stokes solve uses the plane-Gauss-Seidel
V-cycle and Newton the Chebyshev one, as in the JAX package (see
``config.SolverConfig.pc``); the double-float refinement is not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT, Config, default_device, default_dtype
from ..fem.bc import DirichletBC, bc_mask, bc_vector, combine_bcs
from ..fem.interpolate import build_locator, interpolate_p1_np
from ..fem.space import MixedVelocityPressureSpace, make_mixed_space
from ..forms.navier_stokes import make_ns_sups_kernel
from ..forms.stokes import make_stokes_kernel
from ..mesh.core import SimplexMesh
from ..mesh.extrude import extrude_channel
from ..mesh.image import get_contours, load_image, optimize_contour
from ..mesh.tri2d import triangulate_cross_section
from ..solve.driver import solve_linear_layered, solve_newton_layered
from ..solve.newton import KSP_TYPES
from ..utils.device import sync
from .inlet import InletProfile, solve_inlet_profiles


@dataclasses.dataclass
class ChannelSolution:
    mesh: SimplexMesh
    space: MixedVelocityPressureSpace
    w: np.ndarray
    u: np.ndarray                  # (n_nodes, 3)
    p: np.ndarray                  # (n_nodes,)
    Re: float
    newton_iters: int
    newton_resnorm: float
    converged: bool
    timings: dict
    stokes_iters: int = 0
    # Newton history per solve ("coarse_ns_Re<r>" per ladder rung, then
    # "fine_ns"): rows [|F| after step, lambda, Krylov its (TFQMR:
    # matvecs), Krylov |r|]
    newton_history: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)


def generate_channel_mesh(
    img_fname: str, lc: float, cfg: Config = DEFAULT, layered: bool = True,
) -> Tuple[SimplexMesh, np.ndarray, np.ndarray]:
    """Image -> marked 3D channel tet mesh (reference image2gmsh3D.main).

    Returns (mesh, inner_loop, outer_loop) in (y, z) coordinates.
    layered=True (the default here, unlike the JAX package) keeps the
    plane-major node grid the layered operator needs; layered=False
    compacts the nodes away from the solid splitter interior, as the
    block-CSR apps (apps/stokes_channel.py) mesh it.
    """
    gray = load_image(img_fname)
    contours = get_contours(gray, cfg.contour)
    if len(contours) != 2:
        raise ValueError(
            f"expected 2 contours in {img_fname}, found {len(contours)}")
    outer_c, _ = optimize_contour(
        contours[0], cfg.contour.fft_cutoff_3d, cfg.contour.rdp_epsilon,
        cfg.contour.mesh_lc_frac_3d)
    inner_c, _ = optimize_contour(
        contours[1], cfg.contour.fft_cutoff_3d, cfg.contour.rdp_epsilon,
        cfg.contour.mesh_lc_frac_3d)
    inner_loop = inner_c[:, [1, 0]]
    outer_loop = outer_c[:, [1, 0]]
    tri = triangulate_cross_section(
        inner_loop, outer_loop, lc, cfg.channel.half_width)
    mesh = extrude_channel(tri, inner_loop, cfg.channel, lc,
                           compact=not layered)
    return mesh, inner_loop, outer_loop


def channel_bcs(
    mesh: SimplexMesh,
    W: MixedVelocityPressureSpace,
    inlet1: InletProfile,
    inlet2: InletProfile,
) -> DirichletBC:
    """No-slip walls + inlet profiles + outlet pressure (reference
    :127-147).  List order matches the reference's set_bc order (later
    wins on shared dofs)."""

    def vdofs(nodes):
        return np.stack(
            [W.velocity_dof(nodes, c) for c in range(3)], -1).ravel()

    wall = mesh.nodes_with_marker(4)
    n1 = mesh.nodes_with_marker(1)
    n2 = mesh.nodes_with_marker(2)
    out = mesh.nodes_with_marker(3)

    v1 = np.zeros((len(n1), 3))
    v1[:, 0] = inlet1.eval(mesh.points[n1][:, 1:3])
    v2 = np.zeros((len(n2), 3))
    v2[:, 0] = inlet2.eval(mesh.points[n2][:, 1:3])

    return combine_bcs([
        DirichletBC(vdofs(wall), np.zeros(3 * len(wall))),
        DirichletBC(vdofs(n1), v1.ravel()),
        DirichletBC(vdofs(n2), v2.ravel()),
        DirichletBC(W.pressure_dof(out), np.zeros(len(out))),
    ])


def interpolate_solution(
    src_mesh: SimplexMesh,
    src_space: MixedVelocityPressureSpace,
    w_src: np.ndarray,
    dst_mesh: SimplexMesh,
    dst_space: MixedVelocityPressureSpace,
) -> np.ndarray:
    """Coarse -> fine initial guess (reference interpolate_initial_guess,
    :175-194; padding 1e-6, outside points get zero)."""
    u, p = src_space.split(np.asarray(w_src))
    loc = build_locator(src_mesh)
    pts = dst_mesh.points
    u_i = interpolate_p1_np(src_mesh, u, pts, loc, tol=1e-6)
    p_i = interpolate_p1_np(src_mesh, p, pts, loc, tol=1e-6)
    return dst_space.combine(u_i, p_i)


@dataclasses.dataclass
class LayeredSetup:
    """Everything one mesh's layered solves need."""

    space: MixedVelocityPressureSpace
    lp: object                     # assemble.layered.LayeredPattern
    mask: torch.Tensor
    g: torch.Tensor
    mg: object = None              # solve.mg.MGHierarchy or None


def _setup_layered(mesh, inlet1, inlet2, dtype=None, mg_levels=0,
                   device=None) -> LayeredSetup:
    """Layered-solver setup: BCs plus identity rows on the unused nodes of
    the solid splitter interior; mg_levels > 0 also builds the multigrid
    hierarchy (solve/mg.py)."""
    from ..assemble.layered import build_layered
    from ..solve.mg import build_mg_hierarchy

    dtype = default_dtype() if dtype is None else dtype
    W = make_mixed_space(mesh, 1, 1)
    n2d, n_planes, used = mesh.layered
    lp = build_layered(W, n2d, n_planes, dtype, device)
    bc = channel_bcs(mesh, W, inlet1, inlet2)
    unused_nodes = np.nonzero(~used)[0].astype(np.int64)
    bs = W.block_size
    unused_dofs = (unused_nodes[:, None] * bs
                   + np.arange(bs)[None, :]).ravel()
    bc = combine_bcs(
        [DirichletBC(unused_dofs, np.zeros(len(unused_dofs))), bc])
    mask_np = bc_mask(W.ndofs, bc)
    mask = torch.as_tensor(mask_np, dtype=dtype, device=device)
    g = torch.as_tensor(bc_vector(W.ndofs, bc), dtype=dtype, device=device)
    mg = None
    if mg_levels > 0:
        mg = build_mg_hierarchy(
            lp.rows2d, lp.cols2d, lp.n2d, lp.n_planes,
            mask_np.astype(np.float32), lp.bs, n_levels=mg_levels,
            device=device)
    return LayeredSetup(W, lp, mask, g, mg)


def _mg_levels(scfg) -> int:
    """Multigrid levels to build: 0 unless a solve uses the V-cycle."""
    return scfg.mg_levels if (scfg.pc.startswith("mg")
                              or scfg.pc_newton.startswith("mg")) else 0


def _newton(kernel, st: LayeredSetup, w0, scfg):
    lp = st.lp
    return solve_newton_layered(
        kernel, lp.n2d, lp.n_planes, lp.bs, lp.arrays, st.mask, st.g, w0,
        lp.E, scfg.newton_rtol, scfg.newton_atol, scfg.newton_max_it,
        scfg.ksp_rtol, scfg.ksp_restart, 40, scfg.pc_newton, st.mg,
        scfg.ksp_type)


def solve_ns_flow(
    Re: float,
    img_fname: str,
    flowrate_ratio: float,
    channel_mesh_size: float = 0.1,
    cfg: Config = DEFAULT,
    coarse_Re: Optional[float] = None,
    coarse_lc: float = 0.1,
    dtype: Optional[torch.dtype] = None,
    device=None,
    warm: Optional[ChannelSolution] = None,
) -> ChannelSolution:
    """Full continuation solve (reference solve_NS_flow, :468-549).

    coarse_Re defaults to the target Re (solve_NS_flow:522); the reference
    main() instead uses Re=1 for the coarse pass (:567).  With
    coarse_lc == channel_mesh_size the coarse solve is the result and the
    fine Newton only re-checks it.

    warm: a ChannelSolution of a DIFFERENT Re on the SAME (image, lc) — a
    Reynolds-sweep fast path the per-run reference contract lacks
    (run_all_RE.sh re-runs the whole pipeline per Re): the coarse
    mesh/Stokes/coarse-NS/interpolation phases are skipped and the fine
    Newton starts from the previous Re's fine solution.  The converged
    result is the same to the Newton tolerance (same tolerances on the
    same fine operator); only the initial guess changes.  Ignored when the
    mesh shape does not match (e.g. a different lc).
    """
    scfg = cfg.solver
    dtype = default_dtype() if dtype is None else dtype
    device = default_device() if device is None else torch.device(device)
    if scfg.refine == "on" or (scfg.refine == "auto"
                               and dtype == torch.float32):
        raise NotImplementedError(
            "double-float refinement is not ported: solve in float64")
    if scfg.ksp_type not in KSP_TYPES:
        raise ValueError(f"ksp_type={scfg.ksp_type!r}: expected one of "
                         f"{KSP_TYPES}")
    timings = {}

    t0 = time.perf_counter()
    inlet1, inlet2 = solve_inlet_profiles(img_fname, flowrate_ratio, cfg)
    timings["inlet_profiles"] = time.perf_counter() - t0

    if warm is not None:
        sol = _solve_ns_flow_warm(Re, img_fname, inlet1, inlet2,
                                  channel_mesh_size, cfg, dtype, device,
                                  warm, timings)
        if sol is not None:
            return sol
        # shape mismatch: fall through to the full continuation solve

    # ---- coarse mesh: Stokes + NS --------------------------------------
    t0 = time.perf_counter()
    mesh_c, _, _ = generate_channel_mesh(img_fname, coarse_lc, cfg)
    timings["coarse_mesh"] = time.perf_counter() - t0

    stokes_k = make_stokes_kernel(
        "tetrahedron", nu=1.0, mu_T_coeff=cfg.stab.stokes_mu_T_coeff)
    cRe = Re if coarse_Re is None else coarse_Re

    def ns_kernel(r):
        return make_ns_sups_kernel(
            "tetrahedron", nu=1.0 / r, C_I=cfg.stab.C_I,
            transposed_stab=cfg.stab.transposed_advection_in_stab)

    # Reynolds continuation on the coarse mesh: Newton straight from the
    # Stokes init stalls above Re ~ 60; a short geometric Re ladder keeps
    # every rung inside Newton's basin at coarse-mesh cost.
    if cRe > 50:
        n_rungs = int(np.ceil(np.log2(cRe / 25.0))) + 1
        re_ladder = list(np.geomspace(25.0, cRe, n_rungs + 1)[1:])
    else:
        re_ladder = [cRe]

    t0 = time.perf_counter()
    st_c = _setup_layered(mesh_c, inlet1, inlet2, dtype, _mg_levels(scfg),
                          device)
    sync(device)
    timings["coarse_setup"] = time.perf_counter() - t0
    lp_c = st_c.lp
    t0 = time.perf_counter()
    sres = solve_linear_layered(
        stokes_k, lp_c.n2d, lp_c.n_planes, lp_c.bs, lp_c.arrays,
        st_c.mask, st_c.g, lp_c.E, 1e-8, scfg.ksp_restart, scfg.pc, st_c.mg)
    sync(device)
    timings["stokes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_rung = sres.x
    history = {}
    for r in re_ladder:
        nres_c = _newton(ns_kernel(r), st_c, x_rung, scfg)
        history[f"coarse_ns_Re{float(r):g}"] = nres_c.history
        x_rung = nres_c.x
    sync(device)
    timings["coarse_ns"] = time.perf_counter() - t0

    # ---- fine mesh: NS from interpolated coarse ------------------------
    if abs(channel_mesh_size - coarse_lc) < 1e-12:
        mesh_f, st_f, w0_f = mesh_c, st_c, nres_c.x
    else:
        t0 = time.perf_counter()
        mesh_f, _, _ = generate_channel_mesh(img_fname, channel_mesh_size,
                                             cfg)
        timings["fine_mesh"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        st_f = _setup_layered(mesh_f, inlet1, inlet2, dtype,
                              _mg_levels(scfg), device)
        sync(device)
        timings["fine_setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        w_c = nres_c.x.cpu().numpy()
        w0_f = torch.as_tensor(
            interpolate_solution(mesh_c, st_c.space, w_c, mesh_f,
                                 st_f.space), dtype=dtype, device=device)
        # re-impose BC values exactly on the fine mesh
        w0_f = st_f.mask * w0_f + (1.0 - st_f.mask) * st_f.g
        timings["interpolate"] = time.perf_counter() - t0

    sol = _fine_newton(Re, cfg, mesh_f, st_f, ns_kernel(Re), w0_f, timings,
                       device)
    sol.stokes_iters = int(sres.iters)
    sol.newton_history = {**history, **sol.newton_history}
    return sol


def _fine_newton(Re, cfg, mesh_f, st_f: LayeredSetup, ns_f, w0_f,
                 timings, device) -> ChannelSolution:
    """Fine-mesh Newton + result packaging (the JAX package's
    ``_fine_newton_refine`` without its refinement branch)."""
    t0 = time.perf_counter()
    nres_f = _newton(ns_f, st_f, w0_f, cfg.solver)
    sync(device)
    timings["fine_ns"] = time.perf_counter() - t0
    w = nres_f.x.cpu().numpy()
    u, p = st_f.space.split(w)
    return ChannelSolution(
        mesh_f, st_f.space, w, u, p, Re, int(nres_f.iters),
        float(nres_f.resnorm), bool(nres_f.converged), timings,
        newton_history={"fine_ns": nres_f.history})


def _solve_ns_flow_warm(Re, img_fname, inlet1, inlet2, lc, cfg, dtype,
                        device, warm: ChannelSolution, timings
                        ) -> Optional[ChannelSolution]:
    """Reynolds-sweep warm path: fine mesh + setup only, Newton from the
    previous Re's fine solution.  Returns None on shape mismatch (the
    caller falls back to the full continuation solve)."""
    t0 = time.perf_counter()
    mesh_f, _, _ = generate_channel_mesh(img_fname, lc, cfg)
    timings["fine_mesh"] = time.perf_counter() - t0
    if (mesh_f.points.shape != warm.mesh.points.shape
            or mesh_f.cells.shape != warm.mesh.cells.shape):
        return None
    t0 = time.perf_counter()
    st_f = _setup_layered(mesh_f, inlet1, inlet2, dtype,
                          _mg_levels(cfg.solver), device)
    sync(device)
    timings["fine_setup"] = time.perf_counter() - t0
    w0_f = torch.as_tensor(np.asarray(warm.w), dtype=dtype, device=device)
    # re-impose the (Re-independent) BC values exactly
    w0_f = st_f.mask * w0_f + (1.0 - st_f.mask) * st_f.g
    ns_f = make_ns_sups_kernel(
        "tetrahedron", nu=1.0 / Re, C_I=cfg.stab.C_I,
        transposed_stab=cfg.stab.transposed_advection_in_stab)
    return _fine_newton(Re, cfg, mesh_f, st_f, ns_f, w0_f, timings, device)


def solve_ns_flow_single_mesh(
    Re: float,
    img_fname: str,
    flowrate_ratio: float,
    channel_mesh_size: float = 0.1,
    cfg: Config = DEFAULT,
    device=None,
) -> ChannelSolution:
    """Single-mesh variant without coarse->fine continuation — the
    reference's OldNavierStokesChannelFlow.py pipeline (SURVEY.md 2.1:
    'Single-mesh variant of the flagship ... kept for reference')."""
    return solve_ns_flow(
        Re, img_fname, flowrate_ratio, channel_mesh_size, cfg,
        coarse_Re=Re, coarse_lc=channel_mesh_size, device=device)
