"""CLI: standalone streamtrace from a saved solution.

Reference NavierStokes/streamtrace.py:667-690 main():
    streamtrace_cli.py <img_fname> <solname> <funcname>
solname is the XDMF basename (without extension); funcname is usually
"Velocity".  num_seeds=50, limits=0.5 (:668-669).  Reads XDMF/HDF5
through io/xdmf.py and writes SVG figures (no h5py, no matplotlib).

    python -m stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.streamtrace_cli \\
        <img> <solname> Velocity
"""

from __future__ import annotations

import os
import sys

from ..config import DEFAULT
from ..flow.inlet import solve_inlet_profiles
from ..io.xdmf import read_xdmf_function
from ..trace.figures import save_trace_figures
from ..trace.pipeline import for_and_rev_streamtrace


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        raise ValueError(
            "Usage: streamtrace_cli.py <img_fname> <solname> <funcname>")
    img_fname, solname, funcname = argv
    img_fname = os.path.abspath(img_fname)
    num_seeds, limits = 50, 0.5

    mesh, u = read_xdmf_function(solname, funcname)
    inlet1, _ = solve_inlet_profiles(img_fname, 0.5, DEFAULT)
    seed_points = inlet1.mesh.points
    result = for_and_rev_streamtrace(
        num_seeds, img_fname, mesh, u, seed_points, DEFAULT, device=device)
    folder = os.path.dirname(img_fname) or "."
    save_trace_figures(folder, img_fname, result, seed_points,
                       num_seeds, limits)
    print(f"outlet profile points: {len(result.outlet_points)}")
    return result


if __name__ == "__main__":
    main()
