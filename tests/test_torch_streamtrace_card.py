"""K3 on the card: the trace's RK45 kernel against its plain version.

This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -q -s \
        tests/test_torch_streamtrace_card.py

(``--noconftest``: tests/conftest.py configures JAX).  Without a card
every test skips.  ``trace_k3`` (csrc/streamtrace.cu) and the plain
version (``trace_segment`` under the compacted rounds of
``trace_particles_plain``, run on the card too) integrate the same seeds
on the same layered locator, in float64 and in float32:

* the stored fields: CHANNEL (lc=0.12, tests/fixtures/channel_ns.npz)
  and the production channel (lc=0.04, channel_ns_prod.npz), forward
  from the inner-inlet vertices and backward from the 200 x 200 reverse
  grid that ``for_and_rev_streamtrace`` builds; per-lane ``done`` and
  ``steps``, the summed ``seed_steps``, the endpoints and the outlet mask
  (the inside/outside test of the pipeline, flips counted);
* a box channel with a linear field (exact in P1, so the two agree to
  rounding over whole trajectories), with lanes built to hit
  ``max_steps``, to stall at the speed stop (seeds outside, and a field
  brought to rest on the planes x >= 3), to leave the domain through its
  side and its end, and to hit the plane forward and backward;
* ``trace_particles`` on the card launches K3 (``k3_launch``, one per
  chunk of seeds), and ``stats["lane_steps"]`` equals ``seed_steps``;
* the wrapper's refusals: a wrong dtype, a CPU tensor, a non-contiguous
  tensor.

Tolerances.  The two sides take the same operations in the same order
except the sums that PyTorch reduces in its own order (the stage
combination, a cuBLAS product; the mean and the norm), so a step
differs in its last bits, and the adaptive step control amplifies that
along a trajectory on the piecewise-linear field (tests/test_torch_trace.py
shows it step by step).  So on the stored fields the bars are those the
port holds against the JAX package (tests/test_torch_trace_pipeline.py,
chip_smoke.py phase 4): in float64 the lanes' ``done`` equal, endpoints
(y, z) within 1e-6 and x within the event bisection's resolution
(2^-16 * max_step * max |u_x|) for lanes that end on the plane, at most
0.1% of the mask flipped and ``seed_steps`` within 0.1%; in float32,
where each step rounds at 6e-8, 1e-3 and 1% (the benchmark's float32
control reads 5.75e-4 against float64 over whole trajectories).  On the
linear field: 1e-10 (float64), 1e-4 (float32) everywhere and equal
``steps`` and ``done``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.interpolate import (
    build_trace_locator)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
    generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
    solve_inlet_profiles)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.tri2d import (
    points_in_polygon)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (
    streamtrace as ts)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace.pipeline import (
    SEED_CHUNK, for_and_rev_streamtrace, trace_config)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (
    counts)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
    make_annulus_image)

from parity_fixtures import CHANNEL, FIXTURE_DIR
from test_torch_streamtrace_k3 import box_channel, linear_field

TC = DEFAULT.trace
NUM_SEEDS = 200
FIELDS = {"channel": (CHANNEL["lc"], "channel_ns.npz"),
          "prod": (0.04, "channel_ns_prod.npz")}
DTYPES = {"float64": torch.float64, "float32": torch.float32}
# (endpoint bar, mask flips and seed_steps share) by dtype, see above
BARS = {torch.float64: (1e-6, 1e-3), torch.float32: (1e-3, 1e-2)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=sorted(FIELDS))
def field(request, tmp_path_factory):
    """A stored field on its mesh, its forward seeds, the reverse grid and
    inner contour of the pipeline, and a locator per dtype."""
    dev = _card()
    lc, fixture = FIELDS[request.param]
    img = make_annulus_image(
        str(tmp_path_factory.mktemp("k3card") / "circle.png"),
        CHANNEL["shape"])
    mesh, _, _ = generate_channel_mesh(img, lc, DEFAULT)
    w = np.load(FIXTURE_DIR / fixture)["w"]
    u = np.asarray(make_mixed_space(mesh, 1, 1).split(w)[0])
    inlet1, _ = solve_inlet_profiles(img, CHANNEL["ratio"], DEFAULT)
    fwd = np.hstack([np.zeros((len(inlet1.mesh.points), 1)),
                     inlet1.mesh.points])
    res = for_and_rev_streamtrace(NUM_SEEDS, img, mesh, u,
                                  inlet1.mesh.points, DEFAULT, device=dev)
    locs = {dt: build_trace_locator(mesh, dt, dev)
            for dt in DTYPES.values()}
    return dict(name=request.param, u=u, fwd=fwd, rev=res.seeds,
                contour=res.inner_contour, locs=locs, dev=dev)


def _twin(cfg, dloc, u_cell, x0):
    """The plain version's per-lane (x, steps, done), in seed order."""
    st, _ = ts._trace_compacted(cfg, dloc, u_cell, x0, SEED_CHUNK,
                                ts.SEG_STEPS)
    out = []
    for k in ("x", "steps", "done"):
        a = getattr(st, k)
        b = torch.empty_like(a)
        b[st.seed_id] = a
        out.append(b.cpu().numpy())
    return out


def _both(cfg, dloc, u, seeds, dtype, dev):
    u_cell = ts.pack_u_cells(dloc, torch.as_tensor(u, dtype=dtype,
                                                   device=dev))
    x0 = torch.as_tensor(seeds, dtype=dtype, device=dev)
    k3 = [t.cpu().numpy() for t in ts.trace_k3(cfg, dloc, u_cell, x0)]
    torch.cuda.synchronize()
    return k3, _twin(cfg, dloc, u_cell, x0)


def _report(what, k3, tw):
    (xk, sk, dk), (xt, st, dt) = k3, tw
    d = np.abs(xk - xt)
    print(f"\n{what}: lanes {len(sk)}, done {int(dk.sum())} / "
          f"{int(dt.sum())}, seed_steps {int(sk.sum())} / {int(st.sum())}, "
          f"steps equal {(sk == st).mean():.4f}, max |dx| {d.max():.3e}")
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_k3_matches_plain_forward(field, dname):
    dtype, dev = DTYPES[dname], field["dev"]
    bar, share = BARS[dtype]
    cfg = trace_config(TC)
    k3, tw = _both(cfg, field["locs"][dtype], field["u"], field["fwd"],
                   dtype, dev)
    d = _report(f"{field['name']} forward {dname}", k3, tw)
    (xk, sk, dk), (xt, st, dt) = k3, tw
    assert (dk == dt).mean() >= 1 - share
    if dtype == torch.float64:
        np.testing.assert_array_equal(dk, dt)
    assert abs(int(sk.sum()) - int(st.sum())) <= share * st.sum()
    on_plane = dk & dt & (xk[:, 0] >= TC.x_forward_stop) \
        & (xt[:, 0] >= TC.x_forward_stop)
    assert on_plane.sum() > 0.5 * len(dk)
    x_res = 2.0 ** -16 * TC.max_step * np.abs(field["u"][:, 0]).max()
    near = (d[on_plane, 1:].max(axis=1) <= bar) \
        & (d[on_plane, 0] <= max(x_res, bar))
    assert near.mean() >= 1 - share


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_k3_matches_plain_on_reverse_grid(field, dname):
    dtype, dev = DTYPES[dname], field["dev"]
    bar, share = BARS[dtype]
    cfg = dataclasses.replace(trace_config(TC, reverse=True), sign=-1.0)
    k3, tw = _both(cfg, field["locs"][dtype], field["u"], field["rev"],
                   dtype, dev)
    d = _report(f"{field['name']} reverse {dname}", k3, tw)
    (xk, sk, dk), (xt, st, dt) = k3, tw
    assert len(sk) == NUM_SEEDS ** 2

    def mask(x):
        x = np.where((x[:, 0] < TC.x_forward_keep)[:, None],
                     x.astype(np.float64), 10.0)
        return points_in_polygon(x[:, 1:3], field["contour"])
    flips = int((mask(xk) != mask(xt)).sum())
    print(f"{field['name']} reverse {dname}: outlet points "
          f"{int(mask(xk).sum())} / {int(mask(xt).sum())}, mask flips "
          f"{flips} of {len(sk)}")
    assert flips <= share * len(sk)
    assert abs(int(sk.sum()) - int(st.sum())) <= share * st.sum()
    assert (dk == dt).mean() >= 1 - share
    both = dk & dt & (np.abs(xk[:, 0] - TC.x_reverse_stop) < 1e-3)
    assert both.sum() > 0.25 * len(dk)
    assert (d[both, 1:].max(axis=1) <= bar).mean() >= 1 - share


@pytest.fixture(scope="module")
def box():
    dev = _card()
    mesh = box_channel(8, 17)
    u = linear_field(mesh)
    # the same field brought to rest on the planes x >= 3 (linearly over
    # the last layer before them): lanes slow down there and stall
    u_rest = np.where((mesh.points[:, 0] >= 3.0)[:, None], 0.0, u)
    return {dt: build_trace_locator(mesh, dt, dev) for dt in
            DTYPES.values()}, {"linear": u, "rest": u_rest}, dev


N_IN = 64          # seeds inside the rotation's radius


def _box_seeds():
    rng = np.random.default_rng(11)
    r = 0.4 * np.sqrt(rng.uniform(0, 1, N_IN))
    th = rng.uniform(0, 2 * np.pi, N_IN)
    inner = np.stack([rng.uniform(0.2, 2.9, N_IN), r * np.cos(th),
                      r * np.sin(th)], axis=1)
    outside = np.array([[2.0, 0.7, 0.0], [1.0, 0.0, -0.6], [-0.5, 0.0, 0.0],
                        [4.5, 0.1, 0.1]])
    leaves = np.array([[1.0, 0.45, 0.45], [2.0, -0.48, 0.4]])  # r > 0.5
    return np.concatenate([inner, outside, leaves])


CASES = {
    # name: (field, config changes, reverse)
    "plane_forward": ("linear", {}, False),
    "plane_reverse": ("linear", {"x_stop": 0.13, "stop_direction": -1},
                      True),
    "max_steps": ("linear", {"max_steps": 5}, False),
    "leaves_the_end": ("linear", {"x_stop": 5.0}, False),
    "stalls": ("rest", {}, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_k3_matches_plain_on_edge_lanes(box, case, dname):
    locs, fields, dev = box
    dtype = DTYPES[dname]
    name, change, reverse = CASES[case]
    cfg = dataclasses.replace(trace_config(TC), **change)
    if reverse:
        cfg = dataclasses.replace(cfg, sign=-1.0)
    seeds = _box_seeds()
    if reverse:
        seeds[:N_IN, 0] = 3.9
    k3, tw = _both(cfg, locs[dtype], fields[name], seeds, dtype, dev)
    d = _report(f"box {case} {dname}", k3, tw)
    (xk, sk, dk), (xt, st, dt) = k3, tw
    np.testing.assert_array_equal(dk, dt)
    np.testing.assert_array_equal(sk, st)
    assert d.max() <= (1e-10 if dtype == torch.float64 else 1e-4)
    # the lanes did what they were built for
    inner, out, leaves = (slice(0, N_IN), slice(N_IN, N_IN + 4),
                          slice(N_IN + 4, None))
    if case == "max_steps":
        assert (sk[inner] == 5).all() and not dk[inner].any()
        return
    assert dk.all()
    if case == "leaves_the_end":
        # past x = 4 the field is zero: a speed stop, not the plane
        assert (xk[inner, 0] >= 4.0).all()
    elif case == "stalls":
        # the lanes come to rest at the plane x = 3 (in float32 some
        # round onto it)
        assert (xk[inner, 0] <= 3.0).all() and (sk[inner] > 10).all()
    else:
        assert (np.abs(xk[inner, 0] - cfg.x_stop) < 1e-4).all()
    # the seeds outside stall at once: one step, done, where they were
    assert (sk[out] == 1).all()
    np.testing.assert_array_equal(xk[out], seeds[out].astype(xk.dtype))
    # the lanes outside the rotation's radius leave through the side
    # and stall there
    if case != "stalls":
        assert (np.abs(xk[leaves, 1:]).max(axis=1) >= 0.5).all()


@pytest.mark.cuda
def test_trace_particles_launches_k3(box):
    locs, fields, dev = box
    u = fields["linear"]
    seeds = _box_seeds()[:N_IN]
    before = counts(ts.COUNTER)
    rounds0 = sum(counts("trace_rounds").values())
    stats = {}
    ends = ts.trace_particles(trace_config(TC), locs[torch.float64],
                              torch.as_tensor(u, device=dev), seeds,
                              chunk=24, stats=stats)
    assert ends.is_cuda and ends.shape == (64, 3)
    launched = counts(ts.COUNTER, before)
    assert sum(launched.values()) == 3 == stats["dispatches"]
    assert sum(counts("trace_rounds").values()) - rounds0 == 3
    assert {k[0] for k in launched} == {24, 16}
    assert {k[3:] for k in launched} == {("float64", "forward")}
    assert stats["lane_steps"] == stats["seed_steps"] > 64
    assert stats["seeds"] == 64
    plain = ts.trace_particles_plain(trace_config(TC), locs[torch.float64],
                                     torch.as_tensor(u, device=dev), seeds,
                                     chunk=24)
    assert (ends - plain).abs().max().item() <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float16", "cpu_seeds", "strided",
                                   "mixed"])
def test_k3_refuses_what_it_does_not_take(box, fault):
    locs, fields, dev = box
    u = fields["linear"]
    dloc = locs[torch.float64]
    u_cell = ts.pack_u_cells(dloc, torch.as_tensor(u, device=dev))
    x0 = torch.as_tensor(_box_seeds(), device=dev)
    if fault == "float16":
        x0 = x0.to(torch.float16)
    elif fault == "cpu_seeds":
        x0 = x0.cpu()
    elif fault == "strided":
        x0 = x0.t().contiguous().t()
        assert not x0.is_contiguous()
    elif fault == "mixed":
        u_cell = u_cell.to(torch.float32)
    with pytest.raises(ValueError, match="streamtrace"):
        ts.trace_k3(trace_config(TC), dloc, u_cell, x0)
