"""BENCHMARK.json resolves to its files and keeps the format it must
have; a cell, a traffic mix, limits and a metric added as new files are
found without an edit."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from conftest import ROOT, tiny_bench
from portbench import run as bench_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert len(json.dumps(b)) <= 64 * 1024
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    assert len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(cells)
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


ENTRY = ("check_program", "cases", "round_length", "judge_rng", "prepare",
         "run", "collect", "judge", "describe", "control_edit")
CHANNEL = ("run_trace_save", "streamtrace_cli")


@pytest.mark.parametrize("cell", [w["name"] for w in load()["workloads"]])
def test_cell_resolves(cell):
    """Each cell's files hold what its driver reads; the channel's
    configuration and the channel's entries keep the channel's."""
    b = load()
    w, cfg, traffic, limits = bench_run.cell_files(b, cell)
    conf = {c["name"]: c for c in b["configs"]}[w["config"]]
    assert cfg["name"] == conf["name"] and conf["reduced"] == cfg["reduced"]
    assert set(cfg["reduced"]) <= set(cfg)
    driver = bench_run.load_module("drivers", traffic["entry"])
    for f in ENTRY:
        assert callable(getattr(driver, f)), f
    assert set(driver.LIMIT_KEYS) <= set(limits)
    assert set(driver.TRAFFIC_KEYS) <= set(traffic)
    if traffic["entry"] in CHANNEL:
        assert cfg["dtype"] == "float64" and cfg["refine"] == "auto"
        assert cfg["snes"]["rtol"] == cfg["snes"]["atol"] == 1e-8
        assert {"residual", "trace_end_err", "geometry_err",
                "reverse_sample", "outlet_band"} <= set(limits)
        assert {"entry", "image", "ratio", "reynolds",
                "warm_start"} <= set(traffic)
        driver.check_program(cfg)
    for m in bench_run.metrics_of(b, cell, "per_layer"):
        assert callable(bench_run.load_metric(m["name"]).read)


def test_added_files_found_without_edit(tmp_path):
    """A new traffic mix, its entry's driver, a limits file and a
    per-layer metric dropped into their folders are found by name."""
    base = tmp_path / "pb"
    shutil.copytree(os.path.join(ROOT, "portbench", "tests", "data"), base)
    (base / "metrics").mkdir(exist_ok=True)
    (base / "drivers").mkdir(exist_ok=True)
    (base / "drivers" / "dummy_entry.py").write_text(
        "def run(case, image, cfg, device, warm):\n    return case\n"
        "def collect(served, case, captured, workdir):\n"
        "    return {}, served, None\n")
    (base / "traffic" / "dummy.json").write_text(json.dumps({
        "entry": "dummy_entry", "image": {"shape": "circle", "size": 64, "r_inner": 0.2,
                  "r_gap": 0.1},
        "ratio": 0.5, "reynolds": {"warmup": 10, "cycle": [10]},
        "warm_start": False}))
    (base / "limits" / "tiny.dummy.json").write_text(json.dumps({
        "residual": 1.0, "trace_end_err": 1.0, "reverse_sample": 1,
        "outlet_band": 0.01}))
    (base / "metrics" / "dummy_cases.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    b = tiny_bench()
    b["workloads"].append({"name": "tiny.dummy", "config": "tiny",
                           "traffic": "dummy", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "dummy_cases", "unit": "cases",
                           "better": "higher", "source": "host_clock",
                           "layer": "harness", "moves": "case_s",
                           "workloads": ["tiny.dummy"]})
    cell, cfg, traffic, limits = bench_run.cell_files(b, "tiny.dummy",
                                                      str(base))
    assert traffic["image"]["size"] == 64 and limits["reverse_sample"] == 1
    ms = bench_run.metrics_of(b, "tiny.dummy", "per_layer")
    assert [m["name"] for m in ms] == ["dummy_cases"]
    mod = bench_run.load_metric("dummy_cases", str(base))
    assert mod.read(bench_run.RunData([{}, {}], None)) == 2.0
    driver = bench_run.load_module("drivers", traffic["entry"], str(base))
    assert driver.collect("served", None, {}, "")[1] == "served"


def test_per_layer_readers_return_nothing_without_data():
    b = load()
    empty = bench_run.RunData([], None)
    for m in b["per_layer"]:
        assert bench_run.load_metric(m["name"]).read(empty) is None
