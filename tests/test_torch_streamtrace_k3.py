"""K3's host side on the CPU (no card, no JAX): the dispatch, the
constants it is handed, its refusals and the benchmark's reader of its
time.

* ``trace_particles`` with CPU tensors takes the plain version
  (``trace_particles_plain``) and gives its result exactly; ``stats``
  keeps its keys, ``dispatches`` counts the segment calls and equals the
  ``trace_dispatches`` counter, ``trace_rounds`` counts the compaction
  rounds, and no ``k3_launch`` is counted.
* The launch's ``Params`` carry ``trace/streamtrace.py``'s tableau, its
  bisection count and step controller and ``fem/interpolate.py``'s
  locator tolerance (the twin's own values), and their fields are the
  kernel source's ``struct Params`` in order.
* ``trace_k3`` refuses CPU tensors, dtypes other than float64 and
  float32, mixed dtypes, non-contiguous seeds and misshapen seeds, each
  with its own message, before it builds anything.
* ``portbench/metrics/k3_ms.py`` reads None without a profile or
  without the kernel, and the kernel's device time in ms otherwise.

The mesh is a 4 x 4 cross-section extruded through 9 x-planes (the
layered locator's structure, built in milliseconds), the field linear
(axial flow and a rigid rotation, exact in P1).
"""

import dataclasses
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem import (
    interpolate as ti)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.core import (
    SimplexMesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.extrude import (
    extrude_tri_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (
    rect_tri)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (
    streamtrace as ts)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import nvcc
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (
    counts)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "stabilized_navier_stokes_flow_fenicsx_tpu_torch",
                      "csrc", "streamtrace.cu")
FWD = dict(t_max=20.0, max_step=0.125, speed_eps=1e-6, x_stop=3.7,
           stop_direction=1, rtol=1e-3, atol=1e-6, max_steps=4096)


def box_channel(n: int = 4, planes: int = 9):
    """An n x n (y, z) cross-section of [-0.5, 0.5]^2 extruded through
    ``planes`` x-planes on [0, 4], as the channel mesher lays it out."""
    m = extrude_tri_mesh(rect_tri(n, n, (-0.5, -0.5), (0.5, 0.5)),
                         np.linspace(0.0, 4.0, planes))
    # (y, z, x) -> (x, y, z), a cyclic permutation: orientation kept
    return SimplexMesh("tetrahedron", m.points[:, [2, 0, 1]].copy(), m.cells)


def linear_field(mesh):
    y, z = mesh.points[:, 1], mesh.points[:, 2]
    return np.stack([np.ones_like(y), -0.5 * z, 0.5 * y], axis=1)


@pytest.fixture(scope="module")
def box():
    mesh = box_channel()
    dloc = ti.build_trace_locator(mesh, torch.float64, "cpu")
    assert isinstance(dloc, ti.LayeredDeviceLocator)
    rng = np.random.default_rng(5)
    r = 0.4 * np.sqrt(rng.uniform(0, 1, 40))
    th = rng.uniform(0, 2 * np.pi, 40)
    seeds = np.stack([rng.uniform(0.2, 3.0, 40), r * np.cos(th),
                      r * np.sin(th)], axis=1)
    return mesh, dloc, torch.as_tensor(linear_field(mesh)), seeds


@pytest.mark.parametrize("chunk", [0, 16])
def test_cpu_takes_the_plain_version(box, chunk):
    mesh, dloc, u, seeds = box
    cfg = ts.TraceConfigDevice(**FWD)
    k3_before = counts(ts.COUNTER)
    rounds0 = sum(counts("trace_rounds").values())
    calls0 = sum(counts("trace_dispatches").values())
    stats = {}
    ends = ts.trace_particles(cfg, dloc, u, seeds, chunk=chunk, seg_steps=8,
                              stats=stats)
    rounds = sum(counts("trace_rounds").values()) - rounds0
    calls = sum(counts("trace_dispatches").values()) - calls0
    plain = ts.trace_particles_plain(cfg, dloc, u, seeds, chunk=chunk,
                                     seg_steps=8)
    assert torch.equal(ends, plain)
    assert set(stats) == {"seeds", "dispatches", "lane_steps", "seed_steps"}
    assert stats["seeds"] == len(seeds)
    assert stats["dispatches"] == calls
    # every lane hits the x = 3.7 plane within 4096 steps
    assert (np.abs(ends.numpy()[:, 0] - 3.7) < 1e-5).all()
    assert stats["seed_steps"] > len(seeds)
    if chunk:
        # 40 lanes in calls of 16: three calls in the first round
        assert rounds >= 2 and calls >= rounds + 2
        assert stats["lane_steps"] >= stats["seed_steps"]
    else:
        # one segment call per round, masked lanes counted
        assert calls == rounds
        assert stats["lane_steps"] == len(seeds) * 8 * rounds
    assert counts(ts.COUNTER, k3_before) == {}


def test_reverse_cpu_trace_ends_on_its_plane(box):
    mesh, dloc, u, seeds = box
    seeds = seeds.copy()
    seeds[:, 0] = 3.9
    cfg = ts.TraceConfigDevice(**{**FWD, "x_stop": 0.13,
                                  "stop_direction": -1})
    stats = {}
    ends = ts.trace_particles(cfg, dloc, u, seeds, reverse=True, chunk=16,
                              stats=stats).numpy()
    assert (np.abs(ends[:, 0] - 0.13) < 1e-5).all()
    # the rigid rotation keeps each seed's radius
    np.testing.assert_allclose(np.hypot(ends[:, 1], ends[:, 2]),
                               np.hypot(seeds[:, 1], seeds[:, 2]), rtol=1e-3)


def _source_fields():
    src = open(SOURCE).read()
    body = re.search(r"struct Params \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        # drop the type: the last words before each comma-separated name
        decl = re.sub(r"^(const\s+)?(unsigned\s+)?[A-Za-z_][A-Za-z0-9_]*"
                      r"(\s+long)?\s*\**\s*", "", decl)
        names += [re.sub(r"\[.*", "", d).strip() for d in decl.split(",")]
    return names


def test_params_match_the_kernel_source():
    assert [f[0] for f in ts._Params._fields_] == _source_fields()


def test_params_carry_the_twin_constants(box):
    mesh, dloc, u, _ = box
    cfg = dataclasses.replace(ts.TraceConfigDevice(**FWD), sign=-1.0,
                              stop_direction=-1, x_stop=0.13)
    u_cell = ts.pack_u_cells(dloc, u)
    P = ts.kernel_params(cfg, dloc, u_cell)
    np.testing.assert_array_equal(np.array([list(r) for r in P.a]), ts._A)
    np.testing.assert_array_equal(np.array(list(P.b5)), ts._B5)
    np.testing.assert_array_equal(np.array(list(P.b4)), ts._B4)
    assert P.n_bisect == ts._N_BISECT == 16
    tol = ti.locate_device_layered.__defaults__[-1]
    assert P.tol == tol == ti.LOCATE_TOL
    assert (P.safety, P.exponent, P.fac_min, P.fac_max, P.dt_min) == (
        ts._SAFETY, ts._EXPONENT, ts._FAC_MIN, ts._FAC_MAX, ts._DT_MIN)
    assert P.t_end == cfg.t_max - ts._T_EPS
    assert (P.t_max, P.max_step, P.speed_eps, P.rtol, P.atol) == (
        cfg.t_max, cfg.max_step, cfg.speed_eps, cfg.rtol, cfg.atol)
    assert (P.x_stop, P.direction, P.sign, P.max_steps) == (0.13, -1.0,
                                                            -1.0, 4096)
    assert (P.Lp, P.nl, P.K2) == (9, 8, dloc.tab2.shape[1])
    assert (P.s0, P.s1) == dloc.shape2
    assert P.prism_base == dloc.prism_base.data_ptr()
    assert P.u_cell == u_cell.data_ptr()


def test_k3_is_built_with_k1_and_k2():
    assert nvcc.KERNELS == ("layered_spmv", "plane_gs", "streamtrace",
                            "soa_element")
    for name in nvcc.KERNELS:
        assert os.path.exists(os.path.join(
            ROOT, "stabilized_navier_stokes_flow_fenicsx_tpu_torch", "csrc",
            f"{name}.cu"))


@pytest.mark.parametrize("fault, match", [
    ("cpu", "runs on a CUDA card"), ("float16", "float64 or float32"),
    ("mixed", "u_cell is torch.float32"), ("strided", "not contiguous"),
    ("shape", r"takes seeds \(n, 3\)")])
def test_k3_refuses_what_it_does_not_take(box, fault, match):
    mesh, dloc, u, seeds = box
    cfg = ts.TraceConfigDevice(**FWD)
    u_cell = ts.pack_u_cells(dloc, u)
    x0 = torch.as_tensor(seeds)
    if fault == "float16":
        x0 = x0.to(torch.float16)
    elif fault == "mixed":
        u_cell = u_cell.to(torch.float32)
    elif fault == "strided":
        x0 = torch.as_tensor(np.asfortranarray(seeds))
        assert not x0.is_contiguous()
    elif fault == "shape":
        x0 = x0[:, :2].contiguous()
    # each fault is found before the device is looked at, and before
    # anything is built
    with pytest.raises(ValueError, match=match):
        ts.trace_k3(cfg, dloc, u_cell, x0)


def _k3_ms():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import run as bench_run

    return bench_run.load_metric("k3_ms")


def test_k3_ms_reads_the_kernel_time():
    read = _k3_ms().read
    run = types.SimpleNamespace(profile=None, records=[])
    assert read(run) is None
    run.profile = types.SimpleNamespace(kernel_s={
        "void (anonymous namespace)::layered_spmv_kernel<double, double, 1>"
        "(...)": 0.046})
    assert read(run) is None
    run.profile.kernel_s.update({
        "void (anonymous namespace)::streamtrace_kernel<double>(...)":
            0.0125,
        "void (anonymous namespace)::streamtrace_kernel<float>(...)":
            0.0025})
    assert read(run) == pytest.approx(15.0, rel=1e-12)
