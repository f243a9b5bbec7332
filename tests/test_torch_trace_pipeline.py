"""The port's forward + reverse trace pipeline against the JAX package.

``trace.pipeline.for_and_rev_streamtrace(24, ...)`` on the CPU in
float64 at the CHANNEL size (lc=0.12, the stored field channel_ns.npz),
from the inner-inlet mesh vertices:

* the same number of kept forward endpoints; their (y, z) within 1e-6
  and their x within the event bisection's resolution
  (2^-16 * max_step * max |u_x|, about 3e-6 here).  Not 1e-8: over a
  whole trajectory the adaptive step control amplifies the last-bit
  differences of the two implementations' sums (tests/test_torch_trace.py
  shows it step by step), and the event x lands on a bisection point
  whose position moves with the last step's size (on the CPU the (y, z)
  differ by at most ~2e-8, and 99.7% of them by under 1e-8);
* the same reverse seed grid (it is built from the forward endpoints'
  alpha shape) to 1e-6, the same inside/outside mask (array_equal) and
  the same outlet points.

The outlet image of postprocess/outlet_image.py is compared on the
result too.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from stabilized_navier_stokes_flow_fenicsx_tpu.config import (  # noqa: E402
    DEFAULT as JAX_DEFAULT)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu.flow.channel import (  # noqa: E402
    generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu.flow.inlet import (  # noqa: E402
    solve_inlet_profiles)
from stabilized_navier_stokes_flow_fenicsx_tpu.postprocess import (  # noqa: E402
    outlet_image as joi)
from stabilized_navier_stokes_flow_fenicsx_tpu.trace import (  # noqa: E402
    pipeline as jp)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.tri2d import (  # noqa: E402
    points_in_polygon)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.postprocess import (  # noqa: E402
    outlet_image as toi)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (  # noqa: E402
    pipeline as tp)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import channel_image  # noqa: E402

NUM_SEEDS = 24


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    img = channel_image(tmp_path_factory.mktemp("pipeline"))
    mesh, _, _ = generate_channel_mesh(img, CHANNEL["lc"], JAX_DEFAULT,
                                       layered=True)
    w = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    u = np.asarray(make_mixed_space(mesh, 1, 1).split(w)[0])
    inlet1, _ = solve_inlet_profiles(img, CHANNEL["ratio"], JAX_DEFAULT)
    seeds = inlet1.mesh.points
    ref = jp.for_and_rev_streamtrace(NUM_SEEDS, img, mesh, u, seeds,
                                     JAX_DEFAULT)
    got = tp.for_and_rev_streamtrace(NUM_SEEDS, img, mesh, u, seeds,
                                     device="cpu")
    return u, ref, got


def test_forward_endpoints_match(both):
    u, ref, got = both
    fj, ft = ref.forward_endpoints, got.forward_endpoints
    assert len(ft) == len(fj) > 0.5 * 386
    np.testing.assert_allclose(ft[:, 1:], fj[:, 1:], rtol=0, atol=1e-6)
    tc = JAX_DEFAULT.trace
    x_res = 2.0 ** -16 * tc.max_step * np.abs(u[:, 0]).max()
    np.testing.assert_allclose(ft[:, 0], fj[:, 0], rtol=0, atol=x_res)
    # the endpoints sit on the event plane, past it by at most x_res
    assert (ft[:, 0] >= tc.x_forward_stop).all()
    assert (ft[:, 0] <= tc.x_forward_stop + x_res).all()


def test_outlet_profile_matches(both):
    _, ref, got = both
    assert got.seeds.shape == (NUM_SEEDS ** 2, 3)
    np.testing.assert_allclose(got.seeds, ref.seeds, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.inner_contour, ref.inner_contour)
    inside_j = points_in_polygon(ref.reverse_endpoints[:, 1:3],
                                 ref.inner_contour)
    inside_t = points_in_polygon(got.reverse_endpoints[:, 1:3],
                                 got.inner_contour)
    np.testing.assert_array_equal(inside_t, inside_j)
    assert 50 < inside_t.sum() < NUM_SEEDS ** 2
    assert got.outlet_points.shape == ref.outlet_points.shape
    np.testing.assert_allclose(got.outlet_points, ref.outlet_points,
                               rtol=0, atol=1e-6)
    s = got.stats
    assert s["seeds"] == 386 + NUM_SEEDS ** 2
    assert s["seed_steps"] == ref.stats["seed_steps"]
    assert s["lane_steps"] >= s["seed_steps"]
    assert {"locator_build_s", "fwd_s", "rev_s"} <= set(s)


def test_outlet_image_matches(both, tmp_path):
    _, ref, got = both
    path = tmp_path / "outlet.png"
    img_t = toi.outlet_image_from_trace(got.seeds, got.reverse_endpoints,
                                        got.inner_contour, path=str(path))
    img_j = joi.outlet_image_from_trace(ref.seeds, ref.reverse_endpoints,
                                        ref.inner_contour)
    np.testing.assert_array_equal(img_t, img_j)
    assert path.exists()
