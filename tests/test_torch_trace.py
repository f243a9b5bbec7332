"""The port's locator and tracer against the JAX package on the CPU in
float64, on the CHANNEL mesh (lc=0.12).

* Locator: 400 seeded points (50 of them exactly on an x-plane) give the
  same cell ids as JAX, barycentrics within 1e-12 where a cell is found,
  and -1 outside the channel; the general grid locator likewise on a
  box mesh.
* Segment: ``trace_segment`` from the same state gives x, v, t, dt within
  1e-10 and equal ``done``/``steps``.  On the stored CHANNEL field this
  holds for 2 steps only: the adaptive step control amplifies the
  last-bit differences of the two implementations' velocity sums by ~10x
  per step there (the P1 field's gradient jumps at every face, and the
  error estimate is a difference of two nearly equal solutions), so the
  longer segment and the compaction are held on a linear field — exact
  in P1, hence smooth — over the same mesh and locator.
* Compaction: one compacted round gives the same not-done count and the
  same order of the active lanes (a stable partition), and the whole
  compacted trace the same endpoints as JAX's and as the port's
  unchunked trace.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.config import (  # noqa: E402
    DEFAULT as JAX_DEFAULT)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem import (  # noqa: E402
    interpolate as ji)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu.flow.channel import (  # noqa: E402
    generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu.flow.inlet import (  # noqa: E402
    solve_inlet_profiles)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh.structured import (  # noqa: E402
    box_tet)
from stabilized_navier_stokes_flow_fenicsx_tpu.trace import (  # noqa: E402
    streamtrace as js)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem import (  # noqa: E402
    interpolate as ti)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (  # noqa: E402
    streamtrace as ts)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import channel_image  # noqa: E402

TC = JAX_DEFAULT.trace
FWD = dict(t_max=TC.t_span, max_step=TC.max_step, speed_eps=TC.speed_eps,
           x_stop=TC.x_forward_stop, stop_direction=1, rtol=TC.rtol,
           atol=TC.atol, max_steps=TC.max_steps)


@pytest.fixture(scope="module")
def channel(tmp_path_factory):
    """CHANNEL mesh, its stored velocity, the forward seeds, and both
    packages' layered locators."""
    img = channel_image(tmp_path_factory.mktemp("trace"))
    mesh, _, _ = generate_channel_mesh(img, CHANNEL["lc"], JAX_DEFAULT,
                                       layered=True)
    w = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    u, _ = make_mixed_space(mesh, 1, 1).split(w)
    inlet1, _ = solve_inlet_profiles(img, CHANNEL["ratio"], JAX_DEFAULT)
    seeds = np.hstack([np.zeros((len(inlet1.mesh.points), 1)),
                       inlet1.mesh.points])
    dl_j = ji.build_trace_locator(mesh)
    dl_t = ti.build_trace_locator(mesh, device="cpu")
    assert isinstance(dl_j, ji.LayeredDeviceLocator)
    assert isinstance(dl_t, ti.LayeredDeviceLocator)
    return mesh, np.asarray(u), seeds, dl_j, dl_t


def _queries(rng, xs, n=400, n_on_plane=50):
    q = np.stack([rng.uniform(-0.1, 4.1, n), rng.uniform(-0.6, 0.6, n),
                  rng.uniform(-0.6, 0.6, n)], axis=1)
    q[:n_on_plane, 0] = rng.choice(xs, n_on_plane)   # exactly on a plane
    return q


def _locate_jax(fn, dloc, q):
    cell, bary = jax.vmap(lambda p: fn(dloc, p))(jnp.asarray(q))
    return np.asarray(cell), np.asarray(bary)


def test_layered_locator_matches_jax(channel):
    mesh, _, _, dl_j, dl_t = channel
    xs = np.unique(mesh.points[:, 0])
    q = _queries(np.random.default_rng(0), xs)
    cj, bj = _locate_jax(ji.locate_device_layered, dl_j, q)
    ct, bt = ti.locate_device_layered(dl_t, torch.as_tensor(q))
    ct, bt = ct.numpy(), bt.numpy()
    inside = cj >= 0
    assert inside.sum() > 200 and inside[:50].sum() > 25
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(bt[inside], bj[inside], rtol=0, atol=1e-12)
    # points outside the channel box locate nowhere
    outside = ((np.abs(q[:, 1:]) > 0.5 + 1e-3).any(axis=1)
               | (q[:, 0] < -1e-3) | (q[:, 0] > 4.0 + 1e-3))
    assert outside.sum() > 50 and (ct[outside] == -1).all()
    # a point strictly inside lies in the cell it was given
    verts = mesh.points[mesh.cells[ct[inside]]]
    np.testing.assert_allclose(np.einsum("nv,nvd->nd", bt[inside], verts),
                               q[inside], atol=1e-12)


def test_general_locator_matches_jax():
    mesh = box_tet((4, 3, 5), (0, 0, 0), (1, 1, 1))
    dl_j = ji.device_locator(ji.build_locator(mesh))
    dl_t = ti.device_locator(ti.build_locator(mesh), device="cpu")
    np.testing.assert_array_equal(dl_t.table.numpy(), np.asarray(dl_j.table))
    assert isinstance(ti.build_trace_locator(mesh, device="cpu"),
                      ti.DeviceLocator)
    rng = np.random.default_rng(1)
    q = rng.uniform(-0.1, 1.1, (400, 3))
    q[:50, 0] = rng.choice(np.unique(mesh.points[:, 0]), 50)
    cj, bj = _locate_jax(ji.locate_device, dl_j, q)
    ct, bt = ti.locate_device(dl_t, torch.as_tensor(q))
    np.testing.assert_array_equal(ct.numpy(), cj)
    found = cj >= 0
    assert 100 < found.sum() < len(q)
    np.testing.assert_allclose(bt.numpy()[found], bj[found], rtol=0,
                               atol=1e-12)


def test_cell_geometry_matches_jax(channel):
    mesh = channel[0]
    pts, cells = mesh.points, mesh.cells
    x0j, Tj = ji._cell_geometry_device(jnp.asarray(pts), jnp.asarray(cells))
    x0t, Tt = ti._cell_geometry_device(torch.as_tensor(pts),
                                       torch.as_tensor(cells))
    np.testing.assert_array_equal(x0t.numpy(), np.asarray(x0j))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-12,
                               atol=1e-12)
    # a degenerate (flat) tet gets NaN rows, so nothing locates in it
    flat = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]])
    _, Tnan = ti._cell_geometry_device(torch.as_tensor(flat),
                                       torch.tensor([[0, 1, 2, 3]]))
    assert torch.isnan(Tnan).all()


def _linear_field(mesh):
    """Axial flow plus a rigid rotation in (y, z): linear, so P1 is
    exact and the trajectory is smooth (radius is conserved)."""
    y, z = mesh.points[:, 1], mesh.points[:, 2]
    return np.stack([np.ones_like(y), -0.5 * z, 0.5 * y], axis=1)


def _linear_seeds(n=300):
    rng = np.random.default_rng(2)
    r = 0.4 * np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2 * np.pi, n)
    return np.stack([rng.uniform(0.6, 3.6, n), r * np.cos(th),
                     r * np.sin(th)], axis=1)


def _states_close(sj, st, tol=1e-10):
    for k in ("x", "v", "t", "dt"):
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(sj, k)), rtol=0,
                                   atol=tol, err_msg=k)
    np.testing.assert_array_equal(st.done.numpy(), np.asarray(sj.done))
    np.testing.assert_array_equal(st.steps.numpy(), np.asarray(sj.steps))
    assert st.steps.dtype == torch.int64


@pytest.mark.parametrize("field, seg_steps", [("stored", 2),
                                               ("linear", 16),
                                               ("linear", 256)])
def test_trace_segment_matches_jax(channel, field, seg_steps):
    mesh, u, seeds, dl_j, dl_t = channel
    if field == "linear":
        u, seeds = _linear_field(mesh), _linear_seeds()
    uc_j = js.pack_u_cells(dl_j, jnp.asarray(u))
    uc_t = ts.pack_u_cells(dl_t, torch.as_tensor(u))
    cfg_j, cfg_t = js.TraceConfigDevice(**FWD), ts.TraceConfigDevice(**FWD)
    s_j = js.trace_segment(
        cfg_j, dl_j, uc_j,
        js.init_trace_state(jnp.asarray(seeds), cfg_j, dl_j, uc_j),
        seg_steps)
    s_t = ts.trace_segment(
        cfg_t, dl_t, uc_t, ts.init_trace_state(seeds, cfg_t, dl_t, uc_t),
        seg_steps)
    _states_close(s_j, s_t)
    done = s_t.done.numpy()
    if seg_steps == 256:
        # every lane hit the x = 3.7 plane event
        assert done.all()
        assert (np.abs(s_t.x.numpy()[:, 0] - 3.7) < 1e-5).all()
    elif field == "linear":
        assert 0 < done.sum() < len(done)


def test_compacted_trace_matches_jax(channel):
    mesh, _, _, dl_j, dl_t = channel
    u, seeds = _linear_field(mesh), _linear_seeds()
    n, chunk, seg = len(seeds), 64, 8
    uc_j = js.pack_u_cells(dl_j, jnp.asarray(u))
    uc_t = ts.pack_u_cells(dl_t, torch.as_tensor(u))
    cfg_j, cfg_t = js.TraceConfigDevice(**FWD), ts.TraceConfigDevice(**FWD)
    # one round: a segment on every lane, then the stable partition
    N = chunk * 8                                 # JAX pads to 2^k chunks
    x0 = np.zeros((N, 3))
    x0[:n] = seeds
    st_j = js._init_full_state(jnp.asarray(x0), cfg_j.max_step,
                               jnp.asarray(n, jnp.int32))
    for k in range(N // chunk):
        st_j = js._run_chunk(cfg_j, dl_j, uc_j, st_j, chunk,
                             jnp.asarray(k * chunk, jnp.int32),
                             jnp.asarray(seg, jnp.int32))
    st_j, na_j = js._compact_state(st_j)
    st_t = ts._init_full_state(torch.as_tensor(seeds), cfg_t.max_step)
    st_t = ts._run_chunk(cfg_t, dl_t, uc_t, st_t, n, 0, seg)
    st_t, na_t = ts._compact_state(st_t)
    na = int(na_t)
    assert na == int(na_j) and 0 < na < n
    assert st_t.seed_id.dtype == torch.int64
    np.testing.assert_array_equal(st_t.seed_id.numpy()[:na],
                                  np.asarray(st_j.seed_id)[:na])
    for k in ("x", "v", "t", "dt"):
        np.testing.assert_allclose(getattr(st_t, k).numpy()[:na],
                                   np.asarray(getattr(st_j, k))[:na],
                                   rtol=0, atol=1e-10, err_msg=k)
    np.testing.assert_array_equal(st_t.steps.numpy()[:na],
                                  np.asarray(st_j.steps)[:na])
    assert st_t.lane_steps == n * seg

    # the whole compacted trace, in batches of `chunk` lanes and as one
    end_j = np.asarray(js.trace_particles(cfg_j, dl_j, jnp.asarray(u),
                                          jnp.asarray(seeds), chunk=chunk))
    stats = {}
    end_t = ts.trace_particles(cfg_t, dl_t, torch.as_tensor(u), seeds,
                               chunk=chunk, stats=stats).numpy()
    np.testing.assert_allclose(end_t, end_j, rtol=0, atol=1e-10)
    one = ts.trace_particles(cfg_t, dl_t, torch.as_tensor(u), seeds,
                             chunk=1 << 16).numpy()
    plain = ts.trace_particles(cfg_t, dl_t, torch.as_tensor(u), seeds)
    np.testing.assert_allclose(one, end_t, rtol=0, atol=1e-12)
    np.testing.assert_allclose(plain.numpy(), end_t, rtol=0, atol=1e-12)
    assert stats["seeds"] == n and stats["seed_steps"] > n
    assert stats["lane_steps"] >= stats["seed_steps"]


def test_reverse_trace_negates_the_field(channel):
    """reverse=True integrates -u back to the x = 0.13 plane."""
    mesh, _, _, _, dl_t = channel
    u = _linear_field(mesh)
    seeds = _linear_seeds(20)
    seeds[:, 0] = 3.9
    seeds[:, 1:] *= 0.25           # inside the inner inlet, clear of the
    #                                splitter that ends at x = 0.5
    cfg = ts.TraceConfigDevice(**{**FWD, "x_stop": 0.13,
                                  "stop_direction": -1})
    end = ts.trace_particles(cfg, dl_t, torch.as_tensor(u), seeds,
                             reverse=True, chunk=8).numpy()
    assert (np.abs(end[:, 0] - 0.13) < 1e-5).all()
    r0 = np.hypot(seeds[:, 1], seeds[:, 2])
    np.testing.assert_allclose(np.hypot(end[:, 1], end[:, 2]), r0,
                               rtol=1e-3)
