"""Central typed configuration.

The reference scatters hard-coded constants across files (SURVEY.md section 5):
domain extents x_outlet=4.0 / x_extrude=0.5 (image2gmsh3D.py:192-194),
stabilization C_I=36 (NavierStokesChannelFlow.py:237), streamtrace event planes
3.7/0.13/3.9 (streamtrace.py:183,188,353), alpha=0.2 / blurr=0.2
(streamtrace.py:300,317), FFT cutoffs 0.12/0.15 and RDP eps=5e-4
(image2inlet.py:110-119, image2gmsh3D.py:124-134).  Here they live in one
dataclass tree so every app and test pulls the same numbers.
"""

from __future__ import annotations

import dataclasses

import torch


def default_dtype() -> torch.dtype:
    """Library-wide solve dtype: float64.

    The card runs f64 natively, so the solve needs no compensated
    arithmetic (``SolverConfig.refine="auto"`` resolves to off).
    """
    return torch.float64


def default_device() -> torch.device:
    """The card: the port's entry points run on it unless the caller
    passes ``device="cpu"``.  Raises without a card; never falls back."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: torch.cuda.is_available() is false; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class ContourConfig:
    """Image -> contour extraction (ref image2inlet.py:58-139)."""
    level: float = 0.5               # marching-squares threshold
    min_area_frac: float = 0.05      # keep contours enclosing >= 5% of image
    fft_cutoff_inlet: float = 0.12   # low-pass cutoff, inlet meshes (:110)
    fft_cutoff_3d: float = 0.15      # low-pass cutoff, 3D mesher (image2gmsh3D.py:124)
    rdp_epsilon: float = 5e-4        # Ramer-Douglas-Peucker tolerance (:119)
    mesh_lc_frac_inlet: float = 0.05   # mesh_lc = 0.05 * bbox-min-extent (:137)
    mesh_lc_frac_3d: float = 0.01      # (image2gmsh3D.py:147 analogue)


@dataclasses.dataclass(frozen=True)
class ChannelGeometry:
    """3D channel domain (ref image2gmsh3D.py:192-198)."""
    x_inlet: float = 0.0
    x_outlet: float = 4.0
    x_extrude: float = 0.5           # interior splitter walls end here
    half_width: float = 0.5          # cross-section is [-0.5, 0.5]^2
    # refinement-box semantics (image2gmsh3D.py:445-483): fine cells for
    # x < x_extrude - 0.25 at 0.75*lc, lc/2 band after the splitter tip,
    # 0.75*lc/2 right at the tip, 2*lc near the outlet.
    lc_inlet_factor: float = 0.75
    lc_tip_factor: float = 0.375
    lc_mid_factor: float = 0.5
    lc_outlet_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class StabilizationConfig:
    """Stabilized-form constants."""
    C_I: float = 36.0                # SUPS constant (NavierStokesChannelFlow.py:237)
    stokes_mu_T_coeff: float = 0.2   # mu_T = 0.2 h^2 (:169)
    # The reference's SUPS residual and SUPG test function use UFL dot(u, grad(.)),
    # which contracts the component index: (grad u)^T u, not (u . grad) u
    # (NavierStokesChannelFlow.py:241,247 vs :243 which uses nabla_grad).
    # True  -> bit-match the reference's quirk.
    # False -> textbook SUPS residual (u . grad) u.
    transposed_advection_in_stab: bool = True


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Newton / Krylov budgets (NavierStokesChannelFlow.py:281-283)."""
    newton_rtol: float = 1e-8
    newton_atol: float = 1e-8
    newton_max_it: int = 30
    # DELIBERATE performance deviation, as in the JAX package: the
    # reference sets the SNES KSP rtol to 1e-8 (NavierStokesChannelFlow.py:
    # 283).  The OUTER Newton tolerance (1e-8, above) fixes the final
    # accuracy, so looser inner solves reach the same converged field.
    # Pass ksp_rtol=1e-8 for inner-solve parity with the reference.
    ksp_rtol: float = 1e-5
    ksp_restart: int = 50            # FGMRES restart length
    # Newton inner Krylov: "fgmres" (default — robust on the stabilized
    # saddle point and cheapest per matvec here) or "tfqmr", the
    # reference's actual SNES KSP (NavierStokesChannelFlow.py:198-202)
    # for exact algorithmic parity; tfqmr gets the same total matvec
    # budget (restart * max_restarts).  Any other name raises.  TFQMR is
    # not flexible: give it a fixed linear preconditioner, pc_newton=
    # "mg_cheby" — under the bf16 V-cycle (f32 iterate over bf16 values)
    # it stalled at the matvec budget and broke down to NaN at lc=0.04 on
    # the H100 (PERF.md).
    ksp_type: str = "fgmres"
    # double-float iterative refinement: "auto" enables it exactly when
    # the solve dtype is float32, which the port never uses (f64 solves),
    # so it resolves to off.  The double-float stack is not ported:
    # "on" (or "auto" with a float32 solve) raises NotImplementedError.
    refine: str = "auto"
    # layered-operator preconditioners (solve/driver.py::_layered_pc):
    # "mg[_<smoother>][<degree>][w][_bf16]" = aggregation multigrid
    # (solve/mg.py; "mg" alone is the plane-Gauss-Seidel V-cycle,
    # "mg_cheby_bf16" the Chebyshev-Jacobi one on bf16 values),
    # "plane_gs[_bf16]", "zebra[_bf16]", "line_cr[_bf16]",
    # "plane_gs_grouped" = those relaxations alone, anything else =
    # node-block Jacobi.  pc drives the LINEAR (Stokes) solves; pc_newton
    # drives the Newton stages.
    pc: str = "mg"
    pc_newton: str = "mg_cheby_bf16"
    mg_levels: int = 3


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Streamtrace parameters (streamtrace.py)."""
    t_span: float = 20.0             # (0, 20) integration window (:199)
    max_step: float = 0.125          # RK45 max step (:206)
    speed_eps: float = 1e-6          # velocity-magnitude terminal event (:178)
    x_forward_stop: float = 3.7      # forward trace plane event (:183)
    x_reverse_stop: float = 0.13     # reverse trace plane event (:188)
    x_forward_keep: float = 0.5      # keep forward endpoints with x > 0.5 (:211)
    x_seed_plane: float = 3.9        # reverse seeds released at x = 3.9 (:352)
    alpha: float = 0.2               # alpha-shape parameter (:300)
    blurr: float = 0.2               # bbox expansion factor (:317)
    num_seeds_batch: int = 200       # InletBatchScript.py:41
    num_seeds_cli: int = 50          # streamtrace.py main (:669)
    limits: float = 0.5              # plot limits
    rtol: float = 1e-3               # RK45 adaptive rtol — scipy solve_ivp
    atol: float = 1e-6               # defaults, which the reference runs at
    # (streamtrace.py:206, 365 pass no tolerances).
    max_steps: int = 4096            # static bound on RK45 steps under vmap


@dataclasses.dataclass(frozen=True)
class Config:
    contour: ContourConfig = ContourConfig()
    channel: ChannelGeometry = ChannelGeometry()
    stab: StabilizationConfig = StabilizationConfig()
    solver: SolverConfig = SolverConfig()
    trace: TraceConfig = TraceConfig()
    inlet_poisson_forcing: float = 10.0   # -lap u = 10 (image2inlet.py:259)


DEFAULT = Config()
