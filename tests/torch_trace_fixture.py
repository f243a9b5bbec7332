"""Stored outlet-profile trace of the production channel: the reference
that chip_smoke.py holds the port's trace against on the card.

    JAX_PLATFORMS=cpu python tests/torch_trace_fixture.py

Runs the JAX package on the CPU in float64: the lc=0.04 channel mesh of
the circle image, the stored Re=10 field tests/fixtures/channel_ns_prod.npz
split into its velocity, and ``for_and_rev_streamtrace(200, ...)`` from
the inner-inlet mesh vertices (reference InletBatchScript.py:41).  Writes
tests/fixtures/trace_prod.npz (``np.savez_compressed``):

* ``forward_endpoints`` (nf, 3): the kept forward endpoints (x > 0.5);
* ``seeds`` (40000, 3): the reverse seed grid at x = 3.9;
* ``inside`` (40000,) bool: whether each seed's backward endpoint lands
  inside the inlet inner contour;
* ``outlet_points`` (m, 2): the predicted outlet profile (y, z);
* ``n_forward_seeds``, ``seed_steps``: algorithmic counts of the run.

Takes ~15 s of CPU.
"""

import os
import pathlib
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from parity_fixtures import CHANNEL_PROD, FIXTURE_DIR  # noqa: E402

NUM_SEEDS = 200


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from stabilized_navier_stokes_flow_fenicsx_tpu.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu.flow.channel import (
        generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu.mesh.tri2d import (
        points_in_polygon)
    from stabilized_navier_stokes_flow_fenicsx_tpu.trace.pipeline import (
        for_and_rev_streamtrace)
    from stabilized_navier_stokes_flow_fenicsx_tpu.utils.testimg import (
        make_annulus_image)

    with tempfile.TemporaryDirectory() as tmp:
        img = make_annulus_image(os.path.join(tmp, "circle.png"),
                                 CHANNEL_PROD["shape"])
        mesh, _, _ = generate_channel_mesh(img, CHANNEL_PROD["lc"], DEFAULT,
                                           layered=True)
        w = np.load(FIXTURE_DIR / "channel_ns_prod.npz")["w"]
        u, _ = make_mixed_space(mesh, 1, 1).split(w)
        inlet1, _ = solve_inlet_profiles(img, CHANNEL_PROD["ratio"], DEFAULT)
        res = for_and_rev_streamtrace(NUM_SEEDS, img, mesh, np.asarray(u),
                                      inlet1.mesh.points, DEFAULT)
    inside = points_in_polygon(res.reverse_endpoints[:, 1:3],
                               res.inner_contour)
    out = FIXTURE_DIR / "trace_prod.npz"
    np.savez_compressed(
        out, forward_endpoints=res.forward_endpoints, seeds=res.seeds,
        inside=inside, outlet_points=res.outlet_points,
        n_forward_seeds=len(inlet1.mesh.points),
        seed_steps=res.stats["seed_steps"])
    print(f"{out}: {len(inlet1.mesh.points)} forward seeds, "
          f"{len(res.forward_endpoints)} kept, {len(res.seeds)} reverse "
          f"seeds, {len(res.outlet_points)} outlet points, "
          f"{res.stats['seed_steps']} RK steps; {out.stat().st_size} bytes")


if __name__ == "__main__":
    main()
