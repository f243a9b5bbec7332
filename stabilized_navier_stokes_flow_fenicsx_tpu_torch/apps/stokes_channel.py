"""CLI: Stokes-only channel flow from an image.

Counterpart of the JAX package's ``apps/stokes_channel.py``; reference
StokesFlow/StokesChannelFlow.py:33-210 — the earlier serial pipeline:
inlet profiles -> 3D channel mesh -> stabilized P1-P1 Stokes (bcgs,
rtol/atol 1e-10) -> norm printouts + XDMF save.  The solve runs on the
card (``device="cpu"`` runs it on the CPU) on the block-CSR path; the XDMF
pair is written to the working directory.

    python -m stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.stokes_channel \\
        <img_fname> <flowrate_ratio> [<channel_mesh_size>]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..assemble.assembly import assembler_for_mixed
from ..config import DEFAULT
from ..fem.bc import bc_mask, bc_vector
from ..fem.space import make_mixed_space
from ..flow.channel import channel_bcs, generate_channel_mesh
from ..flow.inlet import solve_inlet_profiles
from ..forms.stokes import make_stokes_kernel
from ..io.xdmf import write_xdmf_function
from ..solve.driver import solve_linear_bcsr


def solve_stokes_channel(img_fname: str, flowrate_ratio: float,
                         lc: float = 0.1, cfg=DEFAULT, device=None):
    """Returns (mesh, space, u, p, KrylovResult) on the compact channel
    mesh (no nodes in the solid splitter interior)."""
    inlet1, inlet2 = solve_inlet_profiles(img_fname, flowrate_ratio, cfg)
    mesh, _, _ = generate_channel_mesh(img_fname, lc, cfg, layered=False)
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, device=device)
    bc = channel_bcs(mesh, W, inlet1, inlet2)
    mask = asm.vector(bc_mask(W.ndofs, bc))
    g = asm.vector(bc_vector(W.ndofs, bc))
    pat = asm.pattern
    kern = make_stokes_kernel(
        "tetrahedron", nu=1.0, mu_T_coeff=cfg.stab.stokes_mu_T_coeff)
    res = solve_linear_bcsr(
        kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
        1e-10, cfg.solver.ksp_restart, asm.arrays, mask, g)
    u, p = W.split(res.x.cpu().numpy())
    return mesh, W, u, p, res


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        raise ValueError(
            "Usage: stokes_channel.py <img_fname> <flowrate_ratio> [<lc>]")
    img = os.path.abspath(argv[0])
    ratio = float(argv[1])
    lc = float(argv[2]) if len(argv) == 3 else 0.1
    mesh, W, u, p, res = solve_stokes_channel(img, ratio, lc, device=device)
    # norm printouts like the reference (StokesChannelFlow.py:178-184)
    print(f"L2 norm of velocity coefficient vector: "
          f"{np.linalg.norm(u):.6e}")
    print(f"L2 norm of pressure coefficient vector: "
          f"{np.linalg.norm(p):.6e}")
    print(f"Linf norm of velocity coefficient vector: "
          f"{np.abs(u).max():.6e}")
    print(f"Linf norm of pressure coefficient vector: "
          f"{np.abs(p).max():.6e}")
    write_xdmf_function("StokesChannelVelocity", mesh, u, "Velocity")
    write_xdmf_function("StokesChannelPressure", mesh, p, "Pressure")
    return mesh, W, u, p


if __name__ == "__main__":
    main()
