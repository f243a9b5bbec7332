"""Shared pieces of the benchmark's CPU tests.

Run from the repository root:
``python -m pytest -p no:cacheprovider portbench/tests -q``.  The tiny
cells (``tests/data``) run the port on the CPU at lc 0.12 with a
16 x 16 reverse grid.
"""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "portbench", "tests", "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_bench() -> dict:
    """BENCHMARK.json with the two tiny CPU cells added."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/tests/data/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"] += [
        {"name": "tiny.images", "config": "tiny", "traffic": "tiny-images",
         "chips": 1, "why": "CPU tests"},
        {"name": "tiny.sweep", "config": "tiny", "traffic": "tiny-sweep",
         "chips": 1, "why": "CPU tests"}]
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + ["tiny.images", "tiny.sweep"]
    return bench


@pytest.fixture
def bench():
    return tiny_bench()
