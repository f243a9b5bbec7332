"""Stored Stokes-only channel solution: the reference that chip_smoke.py
holds the port's block-CSR Stokes solve against on the card.

    JAX_PLATFORMS=cpu python tests/torch_bcsr_fixture.py

Runs the JAX package on the CPU in float64:
``apps/stokes_channel.py::solve_stokes_channel`` on the circle image at
flow-rate ratio 0.5 and the app's default lc=0.1 (the compact channel
mesh, FGMRES + node-block Jacobi to rtol 1e-10).  Writes
tests/fixtures/stokes_channel.npz (``np.savez_compressed``): ``w`` (the
mixed dof vector), ``lc``, ``ratio``, and ``iters`` (its FGMRES count).

Took 10 s of wall time on the CPU, 6.5 s of it from the image to the
file (16,740 dofs, 810 FGMRES iterations).
"""

import os
import pathlib
import sys
import tempfile
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from parity_fixtures import FIXTURE_DIR  # noqa: E402

SHAPE, RATIO, LC = "circle", 0.5, 0.1


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from stabilized_navier_stokes_flow_fenicsx_tpu.apps.stokes_channel import (
        solve_stokes_channel)
    from stabilized_navier_stokes_flow_fenicsx_tpu.utils.testimg import (
        make_annulus_image)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        img = make_annulus_image(os.path.join(tmp, "circle.png"), SHAPE)
        _, W, _, _, res = solve_stokes_channel(img, RATIO, LC)
    if not bool(res.converged):
        raise RuntimeError("the Stokes solve did not converge")
    w = np.asarray(res.x, np.float64)
    out = FIXTURE_DIR / "stokes_channel.npz"
    np.savez_compressed(out, w=w, lc=LC, ratio=RATIO, iters=int(res.iters))
    print(f"{out}: {W.ndofs} dofs, FGMRES its {int(res.iters)}, |w| "
          f"{np.linalg.norm(w):.6e}; {out.stat().st_size} bytes; "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
