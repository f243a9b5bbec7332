"""The port's slice as a whole: the image-channel continuation solve.

``flow.channel.solve_ns_flow`` on the CPU in float64 at the CHANNEL case
(Re=10, circle, ratio 0.5, lc=0.12, single mesh) must reproduce the
stored CPU-f64 JAX solution tests/fixtures/channel_ns.npz to relative L2
< 1e-6, the bar of tests/test_parity.py.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (  # noqa: E402
    DEFAULT, SolverConfig)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (  # noqa: E402
    solve_ns_flow)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import channel_image, rel_l2  # noqa: E402


def test_channel_slice_matches_fixture(tmp_path):
    img = channel_image(tmp_path)
    sol = solve_ns_flow(CHANNEL["Re"], img, CHANNEL["ratio"],
                        channel_mesh_size=CHANNEL["lc"],
                        coarse_lc=CHANNEL["lc"], device="cpu")
    w_ref = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    assert sol.converged
    assert sol.w.shape == w_ref.shape and np.isfinite(sol.w).all()
    assert rel_l2(sol.w, w_ref) < 1e-6
    # the Newton history rows: [|F|, lambda, FGMRES its, FGMRES |r|]
    hist = sol.newton_history[f"coarse_ns_Re{CHANNEL['Re']:g}"]
    assert hist.shape[1] == 4 and (hist[:, 2] > 0).all()


def test_double_float_refinement_is_not_ported(tmp_path):
    cfg = DEFAULT.__class__(solver=SolverConfig(refine="on"))
    with pytest.raises(NotImplementedError):
        solve_ns_flow(10.0, channel_image(tmp_path), 0.5, cfg=cfg,
                      device="cpu")
