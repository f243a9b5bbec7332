"""The float32 channel with refinement, the port beside the JAX package.

    JAX_PLATFORMS=cpu python tests/torch_refine_report.py

Runs ``flow.channel.solve_ns_flow`` of both packages on the CPU at the
CHANNEL case (tests/parity_fixtures.py: circle, Re=10, ratio 0.5,
lc=0.12, one mesh) with ``dtype=float32`` and the default
``refine="auto"``, and prints for each one line of counts: the Stokes
start's FGMRES iterations and its final |b - A x| (rtol 1e-8 is under
float32's floor, so both end on the 80-restart budget), the fine
Newton's steps and flag, the refinement steps and |F|, and the rel-L2 of
w + w_lo against tests/fixtures/channel_ns.npz.  These are the numbers
tests/test_torch_refine.py holds the port to; the times are not kept.
"""

import pathlib
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64 on)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.flow import (  # noqa: E402
    channel as jax_channel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow import (  # noqa: E402
    channel)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import channel_image, recording, rel_l2  # noqa: E402


def _run(module, img, **kwargs):
    """(solution, the Stokes start's Krylov result)."""
    calls = []
    fn = recording(module, "solve_linear_layered", calls)
    try:
        sol = module.solve_ns_flow(
            CHANNEL["Re"], img, CHANNEL["ratio"],
            channel_mesh_size=CHANNEL["lc"], coarse_lc=CHANNEL["lc"],
            **kwargs)
    finally:
        module.solve_linear_layered = fn
    (stokes,) = calls
    return sol, stokes


def _line(name, sol, stokes, w_ref) -> str:
    w = np.asarray(sol.w, np.float64) + np.asarray(sol.w_lo)
    return (f"{name}: Stokes FGMRES its {int(stokes.iters)}, converged "
            f"{bool(stokes.converged)}, |r| {float(stokes.resnorm):.3e}; "
            f"fine Newton its {int(sol.newton_iters)}, base_converged "
            f"{bool(sol.base_converged)}; refined {bool(sol.refined)}, "
            f"steps {int(sol.refine_iters)}, |F| "
            f"{float(sol.refine_resnorm):.3e}, converged "
            f"{bool(sol.converged)}; rel-L2 of w + w_lo vs channel_ns.npz "
            f"{rel_l2(w, w_ref):.4e}")


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        img = channel_image(pathlib.Path(tmp))
        w_ref = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
        port = _run(channel, img, dtype=torch.float32, device="cpu")
        print(_line("port", *port, w_ref), flush=True)
        ref = _run(jax_channel, img, dtype=jnp.float32)
        print(_line("jax ", *ref, w_ref), flush=True)
