"""CLI: the full batch pipeline — solve + streamtrace + figures.

Reference NavierStokes/InletBatchScript.py: run with
    mpirun -n 6 ./InletBatchScript.py <Re> <img> <ratio> <lc>
(reference run_all_RE.sh:9); here one process drives the card:
    python -m stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.inlet_batch \\
        <Re> <img> <ratio> [<lc>]
num_seeds=200, limits=1 per InletBatchScript.py:41-42.  The checkpoint
round-trip writes and re-reads XDMF/HDF5 through io/xdmf.py and the
figures are SVG text, so the app needs neither h5py nor matplotlib.
A call of ``run_trace_save`` is the span ``case`` (utils/profiling.py):
its spans and counters are kept together in ``profiling.cases()``.
"""

from __future__ import annotations

import sys
import traceback

from ..config import DEFAULT
from ..flow.channel import solve_ns_flow
from ..flow.inlet import solve_inlet_profiles
from ..io.metadata import make_output_folder, write_run_metadata
from ..io.xdmf import read_xdmf_function
from ..trace.figures import save_trace_figures
from ..trace.pipeline import for_and_rev_streamtrace
from ..utils.device import device_count
from ..utils.profiling import span
from .ns_channel import parse_arguments, save_navier_stokes_solution

NUM_SEEDS = 200
LIMITS = 1.0


def run_trace_save(Re, img_fname, flowrate_ratio, channel_mesh_size,
                   num_seeds=NUM_SEEDS, limits=LIMITS, warm=None,
                   device=None):
    """Solve -> save -> re-read from disk -> trace -> figures (the
    reference's exact flow, including the checkpoint round-trip:
    streamtrace re-reads the saved velocity, streamtrace.py:590).

    warm: previous-Re ChannelSolution on the same (image, lc) — the
    sweep fast path (flow/channel.py::_solve_ns_flow_warm).
    device: where the solve and the trace run (default: the card)."""
    try:
        with span("case"):
            sol = solve_ns_flow(Re, img_fname, flowrate_ratio,
                                channel_mesh_size, DEFAULT, warm=warm,
                                device=device)
            with span("metadata"):
                folder, img_name = make_output_folder(
                    Re, img_fname, channel_mesh_size)
                write_run_metadata(
                    folder, Re, img_fname, flowrate_ratio,
                    channel_mesh_size, sol.space.Q.ndofs,
                    sol.space.V.ndofs, device_count(), img_name)
            with span("checkpoint_write"):
                save_navier_stokes_solution(sol, folder)

            # checkpoint round-trip, like the reference
            with span("checkpoint_read"):
                mesh, u = read_xdmf_function(
                    f"{folder}/Re{Re}ChannelVelocity", "Velocity")

            with span("seed_profiles"):
                inlet1, _ = solve_inlet_profiles(img_fname, flowrate_ratio,
                                                 DEFAULT)
            seed_points = inlet1.mesh.points
            with span("trace"):
                result = for_and_rev_streamtrace(
                    num_seeds, img_fname, mesh, u, seed_points, DEFAULT,
                    device=device)
            save_trace_figures(folder, img_fname, result, seed_points,
                               num_seeds, limits)
            print(f"Saved outputs to {folder}", flush=True)
        return sol, result, folder
    except Exception:
        traceback.print_exc()
        raise


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    Re, img_fname, ratio, lc = parse_arguments(argv)
    return run_trace_save(Re, img_fname, ratio, lc, device=device)


if __name__ == "__main__":
    main()
