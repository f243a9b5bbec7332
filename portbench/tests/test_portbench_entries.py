"""Each entry owns its program path (``drivers/<entry>.py``).  A toy
entry with no channel in it runs through ``run.run_cell`` from its own
files under ``tests/data``; the channel's ``run_trace_save`` entry gives
the case streams, image bytes and judge numbers it gave before its code
moved out of ``run.py``; the retrace's stream."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import pytest
import torch

from conftest import DATA, ROOT, tiny_bench
from portbench import control
from portbench import run as bench_run
from portbench.harness import traffic

# recorded from the harness before its channel code moved into
# drivers/run_trace_save.py, with torch on 4 threads (the CPU solve's
# last bits follow the thread count)
GOLDEN = os.path.join(DATA, "run_trace_save_golden.json")
SEEDS = (0, 7, 2 ** 31 + 12345, 3_000_000_001)
BENCH = os.path.join(ROOT, "portbench")


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def toy_bench() -> dict:
    """BENCHMARK.json with the toy cell and its metric added."""
    b = bench_run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    b["configs"].append({"name": "toy", "source": "test",
                         "file": "portbench/tests/data/configs/toy.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "toy.solve", "config": "toy",
                           "traffic": "toy", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "toy_cg_its", "unit": "its/case",
                           "better": "lower", "source": "program_counter",
                           "layer": "toy solve", "moves": "case_s",
                           "workloads": ["toy.solve"]})
    return b


def _toy(trace: int, bench=None, seed: int = 3_000_000_003):
    args = bench_run.parse(["--workload", "toy.solve", "--seed", str(seed),
                            "--seconds", "0", "--trace", str(trace)])
    return bench_run.run_cell(args, device="cpu", bench=bench or toy_bench(),
                              base=DATA)


def test_toy_entry_runs_from_its_own_files():
    """Its own cases, check, judge, limits and metric: correct, with the
    end-to-end metrics untraced and its per-layer metric traced."""
    plain = _toy(0)
    assert plain["correct"] and plain["attempted"] == 3
    assert plain["failed"] == 0
    assert set(plain["metrics"]) == {"case_s", "peak_gib", "setup_s"}
    assert plain["checks"]["rel_err"]["limit"] == 1e-8
    traced = _toy(1)
    assert traced["correct"] and set(traced["metrics"]) == {"toy_cg_its"}
    assert traced["metrics"]["toy_cg_its"]["value"] > 10


def test_toy_entry_control_and_check(tmp_path):
    """The toy's control (its float32 solve) is not correct, and a
    configuration its program does not run stops the run."""
    ctl, = control.readings("toy.solve", "control", [5], 0, "cpu",
                            bench=toy_bench(), base=DATA)
    rel = ctl["checks"]["rel_err"]
    assert not ctl["correct"] and rel["value"] > 10 * rel["limit"]
    cfg = bench_run.load_json(os.path.join(DATA, "configs", "toy.json"))
    (tmp_path / "toy.json").write_text(json.dumps({**cfg,
                                                   "method": "jacobi"}))
    b = toy_bench()
    b["configs"][-1]["file"] = str(tmp_path / "toy.json")
    with pytest.raises(RuntimeError, match="jacobi"):
        _toy(0, bench=b)


@pytest.mark.parametrize("base,name", [
    (BENCH, "images"), (BENCH, "re-sweep"), (DATA, "tiny-images"),
    (DATA, "tiny-sweep")])
def test_run_trace_save_streams_and_images_unchanged(base, name, tmp_path):
    golden = _golden()
    driver = bench_run.load_module("drivers", "run_trace_save")
    t = traffic.load(os.path.join(base, "traffic", f"{name}.json"))
    for seed in SEEDS:
        it = driver.cases(t, seed)
        cases = [next(it) for _ in range(9)]
        assert ([dataclasses.asdict(c) for c in cases]
                == golden["streams"][f"{name}/{seed}"]), seed
        drawn = [hashlib.sha256(open(driver.prepare(c, str(tmp_path)),
                                     "rb").read()).hexdigest()
                 for c in cases[:4]]
        assert drawn == golden["images"][f"{name}/{seed}"], seed


@pytest.mark.parametrize("cell", ["tiny.images", "tiny.sweep"])
def test_run_trace_save_judge_unchanged(cell, monkeypatch):
    """A tiny CPU run's judge numbers, case by case, bit for bit."""
    from portbench.harness import judge

    want = _golden()["judge"][cell]
    seen: list = []
    inner = judge.judge

    def recorded(*args, per_case=None, **kw):
        out = inner(*args, per_case=per_case, **kw)
        seen.extend(per_case)
        return out
    monkeypatch.setattr(judge, "judge", recorded)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        args = bench_run.parse(["--workload", cell, "--seed",
                                "3000000001", "--seconds", "0", "--trace",
                                "0"])
        result = bench_run.run_cell(args, device="cpu", bench=tiny_bench(),
                                    base=DATA)
    finally:
        torch.set_num_threads(threads)
    assert {k: v["value"] for k, v in result["checks"].items()} \
        == want["checks"]
    assert seen == want["per_case"]
    assert (result["attempted"], result["failed"], result["correct"]) == (
        want["attempted"], want["failed"], want["correct"])


@pytest.mark.parametrize("base,name", [(BENCH, "retrace"),
                                       (DATA, "tiny-retrace")])
def test_retrace_stream(base, name):
    """The same cases for every seed, one a round: one image at Re 10,
    ratio 0.5, every case cold (the set-up's checkpoint, not ``warm=``)."""
    t = traffic.load(os.path.join(base, "traffic", f"{name}.json"))
    driver = bench_run.load_module("drivers", t["entry"])
    assert driver.round_length(t) == 1
    first = None
    for seed in SEEDS + (1, 2):
        it = driver.cases(t, seed)
        cases = [next(it) for _ in range(6)]
        assert [c.index for c in cases] == list(range(6))
        work = [(c.Re, c.ratio, c.size, c.r_inner, c.r_outer, c.warm_start)
                for c in cases]
        assert len(set(work)) == 1 and work[0][0] == 10
        assert not work[0][-1] and work[0][1] == 0.5
        assert first is None or work == first
        first = work
