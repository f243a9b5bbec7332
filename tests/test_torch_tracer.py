"""The port's tracer (``utils/profiling.py``) and the benchmark's readers
of it, on the CPU.

* Spans nest: parent ids, case ids, inclusive and self totals (a span
  inside one of its own name counted once), the bounded log, the case's
  counter changes; ``set_enabled(False)`` records nothing while the
  spans still time their blocks.
* One clock: under ``torch.profiler`` a span around a torch op holds
  that op's event interval.
* ``host_reads`` inside ``fgmres`` is one per Arnoldi step plus the
  norms (|b|, the first |r| and per restart cycle |r0| and the exact
  |b - A x|), exactly.
* ``run_trace_save`` at lc 0.12 with the linear and Newton solves and
  the RK45 tracer stubbed: ``sol.timings`` keeps its keys (cold and
  warm) and each equals its span's total; ``stats`` keeps its walls,
  each a span's length; the I/O, figures and trace spans and the reads
  are in the case.
* The six per-layer readers (``portbench/metrics/``) on synthetic cases
  and a ``RunData``: window cases matched by ``t_ns``, None without the
  tracer, and ``k1_roofline_pct`` 83.5% for one bench-shape (f64, f64)
  launch at 0.2562 ms (PERF.md's figure).
"""

import collections
import math
import os
import time
import types

import numpy as np
import pytest
import torch

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import profiling
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (
    count, counts, read, span)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_spans(n):
    return profiling.spans()[-n:]


def test_spans_nest_with_parent_and_case_ids():
    with span("case") as c:
        with span("outer") as o:
            with span("inner") as i1:
                pass
            with span("outer") as o2:         # nested in its own name
                with span("inner") as i2:
                    pass
        with span("inner") as i3:
            pass
    log = _last_spans(6)
    by_id = {s[0]: s for s in log}
    assert [s[3] for s in log] == ["inner", "inner", "outer", "outer",
                                   "inner", "case"]
    assert by_id[c.id][1] is None
    assert by_id[o.id][1] == c.id and by_id[o2.id][1] == o.id
    assert by_id[i1.id][1] == o.id and by_id[i2.id][1] == o2.id
    assert by_id[i3.id][1] == c.id
    assert {s[2] for s in log} == {c.id}
    for s in log:
        assert s[4] <= s[5]
    case = profiling.cases()[-1]
    assert case.id == c.id and (case.t0_ns, case.t1_ns) == (c.t0, c.t1)
    assert case.n_spans == 6
    ns = 1e-9
    assert case.inclusive_s["outer"] == pytest.approx(o.seconds, abs=ns)
    assert case.inclusive_s["inner"] == pytest.approx(
        i1.seconds + i2.seconds + i3.seconds, abs=3 * ns)
    assert case.self_s["outer"] == pytest.approx(
        o.seconds - i1.seconds - i2.seconds, abs=3 * ns)
    assert case.self_s["case"] == pytest.approx(
        c.seconds - o.seconds - i3.seconds, abs=3 * ns)
    assert sum(case.self_s.values()) == pytest.approx(c.seconds,
                                                      abs=6 * ns)


def test_spans_outside_a_case_and_a_second_case_span():
    with span("solo") as s:
        with span("case") as c:                # the case starts here
            with span("case") as c2:           # inside a case: a span
                pass
    log = _last_spans(3)
    assert [x[3] for x in log] == ["case", "case", "solo"]
    assert log[-1][2] is None and log[1][2] == c.id and log[0][2] == c.id
    case = profiling.cases()[-1]
    assert case.id == c.id and case.inclusive_s["case"] == pytest.approx(
        c.seconds, abs=1e-9) and c2.id != c.id and s.id < c.id


def test_case_keeps_its_counter_changes():
    count("widgets", 5, key="a")
    with span("case"):
        count("widgets", 2, key="a")
        count("widgets", key=("b", 1))
        with span("step"):
            read(torch.ones(()))
            read(torch.ones(3), torch.Tensor.tolist)
        read(torch.zeros((), dtype=torch.int64), int)
    case = profiling.cases()[-1]
    assert case.counters["widgets"] == {"a": 2, ("b", 1): 1}
    assert case.counters["host_reads"] == {"step": 2, "case": 1}
    assert counts("widgets")["a"] >= 7


def test_log_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_log", collections.deque(maxlen=4))
    ids = []
    for _ in range(10):
        with span("x") as s:
            pass
        ids.append(s.id)
    assert [s[0] for s in profiling.spans()] == ids[-4:]
    assert profiling.LOG_SPANS == 1 << 18
    assert all(isinstance(v, (int, str, type(None)))
               for s in profiling.spans() for v in s)


def test_disabled_records_nothing():
    before = (profiling.spans()[-1:], dict(profiling._counts),
              len(profiling.cases()))
    profiling.set_enabled(False)
    try:
        with span("case"):
            with span("x", sync="cpu") as s:
                count("widgets")
                assert read(torch.full((), 2.5)) == 2.5
    finally:
        profiling.set_enabled(True)
    assert s.seconds >= 0.0 and s.id is None
    assert (profiling.spans()[-1:], dict(profiling._counts),
            len(profiling.cases())) == before


def test_span_holds_the_profiled_op():
    """Program spans and the profiler's events share ``time.time_ns``
    (the profiler converts its own clock to it; 2 ms of margin on each
    side leave room for that conversion)."""
    x = torch.ones(1 << 16, dtype=torch.float64)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with span("add") as s:
            time.sleep(0.002)
            x.add(1.0)
            time.sleep(0.002)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::add"]
    assert ev
    assert s.t0 <= ev[0].start_ns()
    assert ev[0].start_ns() + ev[0].duration_ns() <= s.t1


@pytest.mark.parametrize("restart", [50, 4])
def test_fgmres_host_reads_one_per_arnoldi_step(restart):
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.krylov import (
        fgmres)

    g = torch.Generator().manual_seed(3)
    n = 30
    A = torch.randn(n, n, dtype=torch.float64, generator=g) \
        + n * torch.eye(n, dtype=torch.float64)
    b = torch.randn(n, dtype=torch.float64, generator=g)
    d = torch.diag(A)
    reads0, its0 = counts("host_reads"), counts("krylov_its")
    res = fgmres(lambda v: A @ v, b, M=lambda v: v / d, rtol=1e-12,
                 restart=restart)
    assert res.converged and res.iters > 4
    cycles = math.ceil(res.iters / restart)
    # |b| and the first |b - A x|; per cycle |r0|, one read of each
    # Arnoldi column (its Gram-Schmidt coefficients and norm) and the
    # exact |b - A x|
    assert counts("host_reads", reads0) == {
        "fgmres": 2 + 2 * cycles + res.iters}
    assert counts("krylov_its", its0) == {"fgmres": res.iters}


def _stub_solves(monkeypatch):
    """Linear and Newton solves that return their start at once."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow import channel
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.newton import (
        NewtonResult)

    def linear(kernel, n2d, n_planes, bs, arrays, mask, g, *args):
        return types.SimpleNamespace(x=g.clone(), iters=3)

    def newton(kernel, st, w0, scfg):
        return NewtonResult(w0, 1, 0.0, True, np.zeros((1, 4)))
    monkeypatch.setattr(channel, "solve_linear_layered", linear)
    monkeypatch.setattr(channel, "_newton", newton)


COLD = {"inlet_profiles", "coarse_mesh", "coarse_setup", "stokes",
        "coarse_ns", "fine_mesh", "fine_setup", "interpolate", "fine_ns"}
WARM = {"inlet_profiles", "fine_mesh", "fine_setup", "fine_ns"}


def test_run_trace_save_spans_fill_timings_and_stats(tmp_path,
                                                     monkeypatch):
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (
        inlet_batch)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import (
        pipeline)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
        make_annulus_image)

    _stub_solves(monkeypatch)

    def rk45(cfg, dloc, u, seeds, reverse, chunk, stats):
        # forward ends past the keep plane, reverse ends back near x 0.1
        shift = torch.tensor([-3.8 if reverse else 1.0, 0.0, 0.0])
        return torch.as_tensor(seeds) + shift
    monkeypatch.setattr(pipeline, "trace_particles", rk45)
    monkeypatch.chdir(tmp_path)
    img = make_annulus_image(str(tmp_path / "circle.png"), "circle")
    sol, res, _ = inlet_batch.run_trace_save(10, img, 0.5, 0.12,
                                             num_seeds=4, device="cpu")
    case = profiling.cases()[-1]
    assert set(sol.timings) == COLD
    for k, v in sol.timings.items():
        assert case.inclusive_s[k] == pytest.approx(v, rel=1e-12), k
    assert set(res.stats) == {"locator_build_s", "fwd_s", "rev_s"}
    assert res.stats["locator_build_s"] == pytest.approx(
        case.inclusive_s["locator"], rel=1e-12)
    assert res.stats["fwd_s"] + res.stats["rev_s"] == pytest.approx(
        case.inclusive_s["rk45"], rel=1e-12)
    assert {"solve", "layered_setup", "build_layered", "mg_hierarchy",
            "interpolate.locate", "interpolate.eval", "metadata",
            "checkpoint_write", "checkpoint_read", "seed_profiles",
            "trace", "contour", "alpha_shape", "outlet_mask",
            "figures"} <= set(case.inclusive_s)
    assert case.inclusive_s["case"] >= case.inclusive_s["solve"] \
        + case.inclusive_s["figures"]
    # the .cpu() exits of the interpolation, the solve and each trace
    assert case.counters["host_reads"] == {"interpolate": 1, "solve": 1,
                                           "rk45": 2}

    warm = inlet_batch.run_trace_save(20, img, 0.5, 0.12, num_seeds=4,
                                      warm=sol, device="cpu")[0]
    case = profiling.cases()[-1]
    assert set(warm.timings) == WARM
    for k, v in warm.timings.items():
        assert case.inclusive_s[k] == pytest.approx(v, rel=1e-12), k


# ---- the benchmark's readers ---------------------------------------


def _metric(name):
    import sys

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import run as bench_run

    return bench_run.load_metric(name)


def _case(cid, t0, t1, inclusive=None, counters=None):
    return profiling.Case(cid, t0, t1, inclusive or {}, inclusive or {},
                          counters or {}, 1)


K1_BENCH = (14064, 128, 2058, "float64", "float64", True)
K2_BENCH = (14064, 128, 2058, "float64", "float64", 2, True)


@pytest.fixture
def run_data(monkeypatch):
    """Two window records around two cases, the warm-up case before and
    the profiled case after them, and a profile of 0.2562 ms of K1 and
    3.607 ms of K2."""
    cases = [
        _case(1, 10, 90, {"residual": 9.0, "figures": 9.0}),   # warm-up
        _case(2, 110, 190,
              {"residual": 1.0, "metadata": 0.01, "checkpoint_write": 0.2,
               "checkpoint_read": 0.1, "figures": 0.4},
              {"host_reads": {"fgmres": 100, "rk45.round": 20}}),
        _case(3, 210, 290,
              {"residual": 3.0, "metadata": 0.03, "checkpoint_write": 0.4,
               "checkpoint_read": 0.1, "figures": 0.2},
              {"host_reads": {"fgmres": 110, "solve": 2}}),
        _case(4, 310, 390, {"residual": 5.0},
              {"k1_launch": {K1_BENCH: 1}, "k2_launch": {K2_BENCH: 1}}),
    ]
    monkeypatch.setattr(profiling, "cases", lambda: list(cases))
    profile = types.SimpleNamespace(kernel_s={
        "void (anonymous namespace)::layered_spmv_kernel<double>":
            0.2562e-3,
        "void plane_gs_kernel<double>": 3.607e-3,
        "at::native::elementwise_kernel": 1.0})
    return types.SimpleNamespace(
        records=[{"t_ns": (100, 200)}, {"t_ns": (200, 300)}],
        profile=profile)


@pytest.mark.parametrize("name,want", [
    ("residual_s", 2.0), ("io_s", 0.42), ("figures_s", 0.3),
    ("host_reads", 116.0)])
def test_window_readers(run_data, name, want):
    assert _metric(name).read(run_data) == pytest.approx(want, rel=1e-12)


def test_roofline_readers(run_data):
    assert _metric("k1_roofline_pct").read(run_data) == pytest.approx(
        83.5, abs=0.05)
    assert _metric("k2_roofline_pct").read(run_data) == pytest.approx(
        100 * 0.2240 / 3.607, abs=0.01)


@pytest.mark.parametrize("name", ["residual_s", "io_s", "figures_s",
                                  "host_reads", "k1_roofline_pct",
                                  "k2_roofline_pct"])
def test_readers_without_the_tracer(run_data, monkeypatch, name):
    reader = _metric(name)
    monkeypatch.setattr(profiling, "cases", lambda: [])
    assert reader.read(run_data) is None          # no case span
    monkeypatch.delattr(profiling, "cases")
    assert reader.read(run_data) is None          # the parent's program
    run_data.records = []
    assert reader.read(run_data) is None


def test_rooflines_without_launches(run_data, monkeypatch):
    cases = profiling.cases()
    cases[-1] = _case(4, 310, 390)
    monkeypatch.setattr(profiling, "cases", lambda: cases)
    assert _metric("k1_roofline_pct").read(run_data) is None
    assert _metric("k2_roofline_pct").read(run_data) is None
