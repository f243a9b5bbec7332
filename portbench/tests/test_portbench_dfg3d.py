"""The ``dfg3d`` entry (``drivers/dfg3d.py``) through ``run.run_cell`` on
the CPU, from its own files under ``tests/data``: DFG 3D-1Z at scale 2.0
(7,336 dofs) judged by the plain reference, the float32 control refused,
the cell's stream and its program check."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import DATA, ROOT
from portbench import control
from portbench import run as bench_run
from portbench.harness import traffic

SEEDS = (0, 7, 2 ** 31 + 12345, 3_000_000_001)
BENCH = os.path.join(ROOT, "portbench")
DFG3D_CELL = "dfg3d-tiny.continuation"
DFG3D_METRICS = ("continuation_s", "continuation_its", "forces_s")


def dfg3d_bench() -> dict:
    """BENCHMARK.json with DFG 3D-1Z at scale 2.0 (7,336 dofs) added on
    the metrics of ``dfg3d-1z.continuation``."""
    b = bench_run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    b["configs"].append({"name": "dfg3d-tiny", "source": "test",
                         "file": "portbench/tests/data/configs/"
                                 "dfg3d-tiny.json",
                         "reduced": ["scale"], "why": "CPU tests"})
    b["workloads"].append({"name": DFG3D_CELL, "config": "dfg3d-tiny",
                           "traffic": "dfg3d-tiny", "chips": 1,
                           "why": "CPU tests"})
    for m in b["per_layer"]:
        if "dfg3d-1z.continuation" in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + [DFG3D_CELL]
    return b


@pytest.fixture
def four_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


def test_dfg3d_entry_sound_traced(four_threads):
    """The sound program through ``run_cell``, traced: correct, with the
    cell's three readers reporting numbers and nothing else."""
    args = bench_run.parse(["--workload", DFG3D_CELL, "--seed",
                            "3000000007", "--seconds", "0", "--trace", "1"])
    result = bench_run.run_cell(args, device="cpu", bench=dfg3d_bench(),
                                base=DATA)
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == set(DFG3D_METRICS)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0.0 < m["forces_s"] < m["continuation_s"]
    assert m["continuation_its"] >= 4
    checks = result["checks"]
    assert set(checks) == {"residual", "force_err", "cd_lit_err", "cl_band"}
    assert checks["force_err"]["value"] <= 1e-10


def test_dfg3d_entry_control_is_not_correct(four_threads):
    """The control (the program's float32 solve) fails by the residual."""
    ctl, = control.readings(DFG3D_CELL, "control", [3_000_000_009], 0,
                            "cpu", bench=dfg3d_bench(), base=DATA)
    res = ctl["checks"]["residual"]
    assert not ctl["correct"] and res["value"] > res["limit"]


def test_dfg3d_stream_and_check(tmp_path):
    """The same case every seed, one a round; a configuration the
    program does not solve stops the run before any case."""
    t = traffic.load(os.path.join(BENCH, "traffic",
                                  "dfg3d-continuation.json"))
    driver = bench_run.load_module("drivers", t["entry"])
    assert driver.round_length(t) == 1
    for seed in SEEDS:
        it = driver.cases(t, seed)
        assert [next(it).index for _ in range(4)] == [0, 1, 2, 3]
    cfg = bench_run.load_json(os.path.join(DATA, "configs",
                                           "dfg3d-tiny.json"))
    driver.check_program(cfg)
    (tmp_path / "dfg3d.json").write_text(json.dumps({**cfg, "nu": 2e-3}))
    b = dfg3d_bench()
    b["configs"][-1]["file"] = str(tmp_path / "dfg3d.json")
    args = bench_run.parse(["--workload", DFG3D_CELL, "--seed", "1",
                            "--seconds", "0", "--trace", "0"])
    with pytest.raises(RuntimeError, match="nu"):
        bench_run.run_cell(args, device="cpu", bench=b, base=DATA)
