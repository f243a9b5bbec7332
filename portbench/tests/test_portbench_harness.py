"""The case generator, the result line, the no-JAX check, the refusal
without a card, the kernels' frozen byte arithmetic and the reference's
isolation."""

from __future__ import annotations

import ast
import json
import os
import sys
import types

import pytest

from conftest import ROOT
from portbench import run as bench_run
from portbench.harness import kernels, traffic

SEEDS = (0, 7, 2 ** 31 + 12345)


def _traffic(name):
    return traffic.load(os.path.join(ROOT, "portbench", "traffic",
                                     f"{name}.json"))


def _take(t, seed, n):
    it = traffic.cases(t, seed)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("name", ["images", "re-sweep"])
def test_streams_repeat_per_seed(name):
    t = _traffic(name)
    for seed in SEEDS:
        assert _take(t, seed, 6) == _take(t, seed, 6)
    # the images come in an order drawn from the seed; the sweep's one
    # image and Reynolds cycle are the same for every seed
    assert (_take(t, 1, 6) != _take(t, 2, 6)) is (name == "images")


@pytest.mark.parametrize("name,length", [("images", 3), ("re-sweep", 4)])
def test_every_round_holds_the_same_work(name, length):
    t = _traffic(name)
    assert traffic.round_length(t) == length
    work = None
    for seed in SEEDS:
        window = _take(t, seed, 1 + 2 * length)[1:]     # case 0 warms up
        for r in (window[:length], window[length:]):
            got = sorted((c.Re, c.r_inner, c.r_outer) for c in r)
            assert work is None or got == work, seed
            work = got


@pytest.mark.parametrize("edit", [
    {"image": {"shape": "square", "size": 64, "r_inner": 0.2,
               "r_gap": 0.1}},
    {"ratio": [0.4, 0.6]},
    {"entry": None}])
def test_traffic_the_generator_cannot_serve_is_refused(edit):
    t = {**_traffic("re-sweep"), **edit}
    with pytest.raises(traffic.TrafficError):
        next(traffic.cases(t, 1))


def test_geometry_error_sound_and_altered(tmp_path):
    """The served meshes of an image read far under the limit; those of
    the mix's next annulus read far over it (lc 0.1, CPU)."""
    from portbench.harness import images, judge
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)

    cfg = bench_run.load_json(os.path.join(
        ROOT, "portbench", "configs", "channel-lc0.04.json"))
    limit = bench_run.load_json(os.path.join(
        ROOT, "portbench", "limits",
        "channel-lc0.04.images.json"))["geometry_err"]
    (a, ga), (b, gb) = _traffic("images")["image"]["set"][:2]
    served = []
    for k, (ri, ro) in enumerate([(a, a + ga), (b, b + gb)]):
        img = images.make_annulus_image(str(tmp_path / f"i{k}.png"), 512,
                                        ri, ro)
        mesh, _, _ = generate_channel_mesh(img, 0.1)
        in1, in2 = solve_inlet_profiles(img, 0.5)
        served.append(dict(points=mesh.points, cells=mesh.cells,
                           inlet1=(in1.mesh.points[:, :2], in1.mesh.cells),
                           inlet2=(in2.mesh.points[:, :2], in2.mesh.cells)))
    case = types.SimpleNamespace(size=512, r_inner=a, r_outer=a + ga)
    sound = judge.geometry_error(types.SimpleNamespace(**vars(case),
                                                       **served[0]), cfg)
    other = judge.geometry_error(types.SimpleNamespace(**vars(case),
                                                       **served[1]), cfg)
    assert sound < limit / 2 and other > 2 * limit


def test_images_stream():
    t = _traffic("images")
    pairs = {(a, a + g) for a, g in t["image"]["set"]}
    k = len(pairs)
    orders = set()
    for seed in SEEDS + (1, 2, 3):
        cs = _take(t, seed, 3 * k)
        assert all(c.Re == 10 and c.ratio == 0.5 and not c.warm_start
                   for c in cs)
        radii = [(c.r_inner, c.r_outer) for c in cs]
        # the warm-up and any k window cases after it hold every image
        assert set(radii[:k]) == set(radii[1:k + 1]) == pairs
        assert radii[k:2 * k] == radii[:k]
        assert all(0.21 <= a <= 0.25 and 0.08 <= b - a <= 0.10 + 1e-12
                   for a, b in radii)
        orders.add(tuple(radii[:k]))
    assert len(orders) > 1


def test_re_sweep_stream():
    for seed in SEEDS:
        cs = _take(_traffic("re-sweep"), seed, 9)
        assert [c.Re for c in cs] == [40, 50, 60, 70, 40, 50, 60, 70, 40]
        assert [c.warm_start for c in cs] == [False] + [True] * 8
        assert {c.ratio for c in cs} == {0.5}
        assert {(c.r_inner, c.r_outer) for c in cs} == {(0.23, 0.23 + 0.09)}


def test_drawn_images_mesh_at_coarse_lc(tmp_path):
    """Every image of the images mix, and the corners of the ranges it
    samples, meshes at the coarse pass's lc 0.1."""
    from portbench.harness import images
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        generate_channel_mesh)

    radii = [(a, a + g) for a, g in _traffic("images")["image"]["set"]]
    radii += [(0.21, 0.29), (0.25, 0.35)]
    for k, (ri, ro) in enumerate(radii):
        p = images.make_annulus_image(str(tmp_path / f"i{k}.png"), 512,
                                      ri, ro)
        mesh, _, _ = generate_channel_mesh(p, 0.1)
        assert mesh.cells.shape[0] > 1000


def test_result_line_format(capsys):
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"case_s": {"value": 12.5, "unit": "s/case"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                         "count": 1, "memory_peak_bytes": 123},
              "checks": {"residual": {"value": 1e-10, "limit": 1e-8}}}
    assert bench_run.emit(result) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert list(last)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check residual")


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    before = set(bench_run.forbidden_modules())
    for name in ("jaxfoo", "flaxen", "stabilized_navier_stokes_flow_fenicsx_tpu_torch"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(bench_run.forbidden_modules()) == before
    for name in ("jax.numpy", "stabilized_navier_stokes_flow_fenicsx_tpu.config"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(bench_run.forbidden_modules()) == before | {
        "jax", "stabilized_navier_stokes_flow_fenicsx_tpu"}


def test_forbidden_module_stops_the_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert bench_run.emit({"checks": {}}) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jaxlib" in err


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = bench_run.main(["--workload", "channel-lc0.04.images", "--seed",
                         "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


@pytest.mark.parametrize("shape,pair,masked,want", [
    ((5037, 77, 749), (8, 8), True, 0.0461),      # lc 0.04, (f64, f64)
    ((5037, 77, 749), (2, 4), True, 0.0120),      # lc 0.04, (bf16, f32)
    ((5037, 77, 749), (8, 4), True, 0.0453),      # lc 0.04, (f64, f32)
    ((14064, 128, 2058), (8, 8), True, 0.2139),   # lc 0.024, (f64, f64)
    ((14064, 128, 2058), (2, 4), True, 0.0554),   # lc 0.024, (bf16, f32)
])
def test_k1_bound_matches_perf_md(shape, pair, masked, want):
    ms, by = kernels.k1_bound(*shape, *pair, masked)
    assert by == "bytes" and round(ms, 4) == want


@pytest.mark.parametrize("shape,pair,want", [
    ((5037, 77, 749), (8, 8), 0.0483),
    ((1471, 39, 225), (8, 8), 0.0072),
    ((14064, 128, 2058), (8, 8), 0.2240),
    ((14064, 128, 2058), (2, 4), 0.0579),
])
def test_k2_bound_matches_perf_md(shape, pair, want):
    ms, by = kernels.k2_bound(*shape, *pair, 2, True)
    assert by == "bytes" and round(ms, 4) == want


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", ["portbench/reference/channel.py",
                                 "portbench/reference/tracer.py",
                                 "portbench/harness/judge.py",
                                 "portbench/harness/images.py"])
def test_reference_imports_nothing_of_the_program(rel):
    for mod in _imports(os.path.join(ROOT, rel)):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax",
                           "stabilized_navier_stokes_flow_fenicsx_tpu",
                           "stabilized_navier_stokes_flow_fenicsx_tpu_torch")


def test_no_module_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    assert mod.split(".")[0] not in (
                        "jax", "jaxlib", "flax",
                        "stabilized_navier_stokes_flow_fenicsx_tpu"), (f, mod)


class _Event:
    def __init__(self, name, start, dur, cuda=True):
        from torch.autograd import DeviceType

        self._v = (name, start, dur,
                   DeviceType.CUDA if cuda else DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


def test_reduce_profile_busy_union_and_idle_ranges():
    from portbench.harness.spans import reduce_profile

    ev = [_Event("k1", 100, 50), _Event("k1", 120, 60), _Event("k2", 400, 100),
          _Event("cudaLaunchKernel", 90, 5, cuda=False)]
    # host ranges: "outer" over the case, "inner" around the gap 180-400
    iv = [("outer", 0, 1000), ("inner", 200, 390)]
    p = reduce_profile(ev, iv, 0, 1000)
    assert p.busy_s == pytest.approx((80 + 100) / 1e9)
    assert p.kernel_s == {"k1": pytest.approx(110 / 1e9),
                          "k2": pytest.approx(100 / 1e9)}
    assert p.window_s == pytest.approx(1000 / 1e9)
    # gaps: 0-100 and 500-1000 under "outer", 180-400 under "inner"
    assert p.idle_by_range == {"outer": pytest.approx(600 / 1e9),
                               "inner": pytest.approx(220 / 1e9)}
