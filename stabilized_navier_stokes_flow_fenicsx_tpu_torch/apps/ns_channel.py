"""CLI: stabilized Navier-Stokes channel flow from an image.

Argv contract of reference NavierStokes/NavierStokesChannelFlow.py:81-93:
    ns_channel.py <Re> <img_fname> <flowrate_ratio> [<channel_mesh_size>]
Reference main() uses Re=1 for the coarse continuation pass (:567) and
saves Re{Re}ChannelPressure/Velocity.xdmf plus RunParameters.txt.  The
solve runs on the card when one is present.

    python -m stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.ns_channel \\
        <Re> <img> <ratio> [lc]
"""

from __future__ import annotations

import os
import sys

import torch

from ..config import DEFAULT
from ..flow.channel import ChannelSolution, solve_ns_flow
from ..io.metadata import make_output_folder, write_run_metadata
from ..io.xdmf import write_xdmf_function


def parse_arguments(argv):
    if len(argv) not in (3, 4):
        raise ValueError(
            "Usage: ns_channel.py <Re> <img_fname> <flowrate_ratio> "
            "[<channel_mesh_size>]")
    Re = int(argv[0])
    img_fname = os.path.abspath(argv[1])
    flowrate_ratio = float(argv[2])
    channel_mesh_size = float(argv[3]) if len(argv) == 4 else 0.1
    return Re, img_fname, flowrate_ratio, channel_mesh_size


def save_navier_stokes_solution(sol: ChannelSolution, folder: str) -> None:
    """Two XDMF files named like the reference
    (NavierStokesChannelFlow.py:333-341)."""
    write_xdmf_function(
        os.path.join(folder, f"Re{sol.Re}ChannelPressure"),
        sol.mesh, sol.p, "Pressure")
    write_xdmf_function(
        os.path.join(folder, f"Re{sol.Re}ChannelVelocity"),
        sol.mesh, sol.u, "Velocity")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    Re, img_fname, ratio, lc = parse_arguments(argv)
    folder, img_name = make_output_folder(Re, img_fname, lc)

    sol = solve_ns_flow(Re, img_fname, ratio, lc, DEFAULT, coarse_Re=1.0)
    print(f"Num SNES iterations: {sol.newton_iters}", flush=True)
    print(f"Converged: {sol.converged}  |F| = {sol.newton_resnorm:.3e}",
          flush=True)
    print(f"Navier-Stokes solve time: "
          f"{sol.timings.get('fine_ns', 0.0):.2f} sec", flush=True)

    save_navier_stokes_solution(sol, folder)
    n_devices = torch.cuda.device_count() if torch.cuda.is_available() else 1
    write_run_metadata(
        folder, Re, img_fname, ratio, lc,
        pressure_dofs=sol.space.Q.ndofs, velocity_dofs=sol.space.V.ndofs,
        n_devices=n_devices, img_name=img_name)
    return sol, folder


if __name__ == "__main__":
    main()
