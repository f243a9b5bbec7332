"""The port's ns_channel CLI against the JAX package's continuation solve.

``apps.ns_channel.main(["10", img, "0.5", "0.12"], device="cpu")`` takes the
coarse->fine branch (coarse lc 0.1 at Re=1, interpolation, fine lc 0.12
at Re=10); its field must match the JAX package's
``solve_ns_flow(10, img, 0.5, 0.12, coarse_Re=1.0)`` to relative L2
< 1e-6, and it writes the reference's output folder.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from stabilized_navier_stokes_flow_fenicsx_tpu.flow.channel import (  # noqa: E402
    solve_ns_flow as jax_solve_ns_flow)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (  # noqa: E402
    ns_channel)

from torch_cases import channel_image, rel_l2  # noqa: E402


def test_ns_channel_main_matches_jax(tmp_path, monkeypatch):
    img = channel_image(tmp_path)
    monkeypatch.chdir(tmp_path)
    sol, folder = ns_channel.main(["10", img, "0.5", "0.12"], device="cpu")
    assert sol.converged
    assert set(sol.timings) >= {"coarse_ns", "interpolate", "fine_ns"}
    # the JAX reference without its compile-overlap thread
    monkeypatch.setenv("SNS_OVERLAP_COMPILE", "0")
    ref = jax_solve_ns_flow(10.0, img, 0.5, 0.12, coarse_Re=1.0)
    assert bool(ref.converged)
    assert rel_l2(sol.w, np.asarray(ref.w)) < 1e-6

    for name in ("Re10ChannelPressure.xdmf", "Re10ChannelVelocity.xdmf",
                 "RunParameters.txt"):
        assert os.path.exists(os.path.join(folder, name)), name
    with open(os.path.join(folder, "RunParameters.txt")) as f:
        assert "1 Devices Used" in f.read()
