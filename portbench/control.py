#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: the program's sound runs
and the control, on many seeds in one process.

    python3 portbench/control.py --workload <cell> --mode sound|control \\
        --seeds 11,12,13 --seconds 20 [--out readings.jsonl]

Each seed is one run of the cell through ``run.run_cell`` (its warm-up
case, then cases until the first that ends after ``--seconds``, judged
as a benchmark run judges them), so that a control run reaches its
``correct`` by the code that decides a benchmark run's.  ``sound`` runs
the program as the configuration states.  ``control`` runs the nearest
precision below the configuration's float64: the program's own float32
solve with refinement off (``dtype`` float32, ``refine`` off), and in
the trace's place the reference tracer in float32.  One JSON line per
seed (``correct``, each number beside its limit, the cases) goes to
standard output and to ``--out``.  The benchmark's own runs never run
this.  Needs the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run as bench_run  # noqa: E402


def control_edit() -> dict:
    """The control's keys for ``run_cell``."""
    import torch

    return {"dtype": "float32", "refine": "off", "trace_dtype": torch.float32}


def readings(workload: str, mode: str, seeds, seconds: float, device,
             bench=None, base: str = bench_run.BENCH, out=None):
    rows = []
    for seed in seeds:
        args = bench_run.parse(["--workload", workload, "--seed", str(seed),
                                "--seconds", str(seconds), "--trace", "0"])
        result = bench_run.run_cell(
            args, device=device, bench=bench, base=base,
            control=control_edit() if mode == "control" else None)
        row = dict(workload=workload, mode=mode, seed=seed,
                   correct=result["correct"], checks=result["checks"],
                   attempted=result["attempted"], failed=result["failed"])
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("sound", "control"), required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch

    device = a.device
    if device is None:
        if not torch.cuda.is_available():
            print("control: needs a CUDA card", file=sys.stderr)
            return 2
        device = "cuda"
        print(f"card: {bench_run.card_line()}", file=sys.stderr, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    readings(a.workload, a.mode, [int(s) for s in a.seeds.split(",")],
             a.seconds, device, out=a.out and os.path.abspath(a.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
