#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Everything that belongs to a program path
is the driver's that the cell's traffic names (``drivers/<entry>.py``;
its functions are listed in ``drivers/run_trace_save.py``): the check
that the program runs as configured, the case stream, each case's
inputs, the call, its record, and the judge.  Set-up loads the port and
runs one untimed case of the stream (which builds the CUDA kernels in
the checkout's ``build/torch_kernels/`` on a checkout's first run);
then the window runs cases back to back until the first end of a round
of the traffic (the driver's ``round_length``) after ``--seconds``.
With ``--trace 1`` one more case runs under ``torch.profiler`` and the
per-layer metrics are reported instead of the end-to-end ones.  After
the window the driver's judge compares every case of it with the plain
reference.  The last line of standard output is the result; each number
judged is printed beside its limit as the last lines of standard error.
Exits nonzero, printing no result, without a CUDA card, when a module of
JAX or of the JAX package is loaded, or when the files of the program
are missing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "stabilized_navier_stokes_flow_fenicsx_tpu")
GIB = 2 ** 30

# every cache of a build or a kernel at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ.setdefault(_var, os.path.join(ROOT, "build", "portbench",
                                             _sub))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

from portbench.harness import RunError  # noqa: E402


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str, base: str = BENCH):
    """(cell, configuration, traffic, limits) of a workload, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, load_json(os.path.join(ROOT, conf["file"])),
            load_json(os.path.join(base, "traffic", f"{cell['traffic']}.json")),
            load_json(os.path.join(base, "limits", f"{workload}.json")))


def metrics_of(bench: dict, workload: str, kind: str):
    """The metrics of ``kind`` ("end_to_end" or "per_layer") the cell
    reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_module(kind: str, name: str, base: str = BENCH):
    """``<base>/<kind>/<name>.py`` (a per-layer metric's reader or an
    entry's driver), else the repository's."""
    path = os.path.join(base, kind, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(BENCH, kind, f"{name}.py")
    if not os.path.exists(path):
        raise RunError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    # registered, as an import would, so that its dataclasses resolve
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, base: str = BENCH):
    """The reader of a per-layer metric: ``<base>/metrics/<name>.py``,
    else the repository's."""
    return load_module("metrics", name, base)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class Runner:
    """Runs the cases of one stream through a driver and keeps what the
    judge and the metrics need."""

    def __init__(self, cfg, traffic, seed, spans, device, workdir, driver):
        self.cfg, self.spans, self.device = cfg, spans, device
        self.workdir = workdir
        self.driver = driver
        self.stream = driver.cases(traffic, seed)
        self.prev = None

    def run(self):
        """Run the next case; returns (record, output) or raises."""
        import torch

        from portbench.harness.spans import delta

        case = next(self.stream)
        # what the last case left in reference cycles goes now, as it
        # would with the upstream's one process per case; otherwise the
        # collector's timing moves the window's peak memory
        gc.collect()
        prepared = self.driver.prepare(case, self.workdir)
        before = self.spans.snapshot()
        self.spans.captured.clear()
        sync = (torch.cuda.synchronize if torch.device(self.device).type
                == "cuda" else (lambda: None))
        t0, n0 = time.perf_counter(), time.time_ns()
        served = self.driver.run(case, prepared, self.cfg, self.device,
                                 self.prev)
        sync()
        wall = time.perf_counter() - t0
        rec = dict(index=case.index, wall_s=wall,
                   t_ns=(n0, time.time_ns()),
                   spans=delta(self.spans.snapshot(), before))
        fields, out, self.prev = self.driver.collect(
            served, case, self.spans.captured, self.workdir)
        rec.update(fields)
        return rec, out


def run_cell(args, device=None, bench=None, base: str = BENCH,
             control: Optional[dict] = None) -> dict:
    """One run; returns the result object (``correct`` and the rest).
    ``device=None`` asks for the card; ``bench`` and ``base`` (the folder
    of ``traffic/``, ``limits/``, ``metrics/`` and ``drivers/``) default
    to the repository's.  ``control`` (the driver's ``control_edit()``
    as ``control.py`` passes it, never a benchmark run's) replaces keys
    of the configuration and is handed to the driver's judge, which puts
    the control in the place of the program's answers."""
    import torch

    if bench is None:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, cfg, traffic, limits = cell_files(bench, args.workload, base)
    driver = load_module("drivers", traffic["entry"], base)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"needs {cell['chips']} CUDA card(s); "
                           f"torch.cuda.is_available() is "
                           f"{torch.cuda.is_available()}")
        device = "cuda"
        print(f"card: {card_line()}; host: {os.cpu_count()} cores, "
              f"{len(os.sched_getaffinity(0))} allowed, torch "
              f"{torch.get_num_threads()} threads", file=sys.stderr,
              flush=True)
    driver.check_program(cfg)
    cfg = {**cfg, **(control or {})}

    from portbench.harness import spans as spans_mod

    on_card = torch.device(device).type == "cuda"
    here = os.getcwd()
    workdir = tempfile.mkdtemp(prefix="portbench-",
                               dir=os.environ.get("TMPDIR"))
    os.chdir(workdir)
    spans = spans_mod.Spans().install()
    try:
        runner = Runner(cfg, traffic, args.seed, spans, device, workdir,
                        driver)
        rec0, _ = runner.run()                          # the warm-up case
        setup_s = time.perf_counter() - T_START
        print(f"set-up {setup_s:.3f} s (warm-up case {rec0['wall_s']:.3f} s)",
              file=sys.stderr, flush=True)
        if rec0.get("folder"):
            shutil.rmtree(rec0["folder"], ignore_errors=True)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        records, outputs, failed = [], [], 0
        rounds = driver.round_length(traffic)
        t0 = time.perf_counter()
        while True:
            try:
                rec, out = runner.run()
                records.append(rec)
                outputs.append(out)
                failed += not rec["converged"]
            except Exception as e:      # a case that raised: no answer
                print(f"case failed: {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                failed += 1
                records.append(None)
            if (time.perf_counter() - t0 >= args.seconds
                    and len(records) % rounds == 0):
                break
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        done = [r for r in records if r is not None and r["converged"]]
        profile = None
        if args.trace:
            profile = profiled_case(runner, spans, on_card)
        runner.prev = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_judge = time.perf_counter()
        per_case: list = []
        numbers = driver.judge(outputs, cfg, limits,
                               driver.judge_rng(args.seed), device,
                               control or None, per_case)
        print(f"judged {len(outputs)} cases in "
              f"{time.perf_counter() - t_judge:.1f} s", file=sys.stderr,
              flush=True)
        for r, j in zip([r for r in records if r is not None], per_case):
            print(driver.describe(r, j), file=sys.stderr, flush=True)
    finally:
        spans.uninstall()
        os.chdir(here)
        shutil.rmtree(workdir, ignore_errors=True)

    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = (failed == 0 and len(done) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    device_out = {"platform": "gpu" if on_card else "cpu", "kind": dev_name,
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": failed}
    data = RunData(records=[r for r in records if r is not None],
                   profile=profile)
    if args.trace:
        metrics = {}
        for m in metrics_of(bench, args.workload, "per_layer"):
            v = load_metric(m["name"], base).read(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_out["busy_s"] = profile.busy_s if profile else 0.0
        device_out["window_s"] = profile.window_s if profile else 0.0
        if profile:
            result["breakdown"] = {
                "device_ops": sorted(([k, v] for k, v in
                                      profile.kernel_s.items()),
                                     key=lambda kv: -kv[1])[:10],
                "idle_gaps": sorted(([k, v] for k, v in
                                     profile.idle_by_range.items()),
                                    key=lambda kv: -kv[1])[:10]}
    else:
        e2e = {"case_s": window_s / max(1, len(done)),
               "peak_gib": peak / GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, args.workload, "end_to_end")}
    result["metrics"] = metrics
    result["device"] = device_out
    result["checks"] = checks
    return result


class RunData:
    """What a per-layer metric reads: the window's case records (host
    walls, the program's timings, trace stats and Newton histories, the
    benchmark's spans) and the profiled case."""

    def __init__(self, records, profile):
        self.records = records
        self.profile = profile


def profiled_case(runner, spans, on_card: bool):
    """One more case of the stream under torch.profiler (device activity
    only, so that the host runs at its unprofiled pace), reduced."""
    import torch

    from portbench.harness.spans import reduce_profile

    act = [torch.profiler.ProfilerActivity.CUDA if on_card
           else torch.profiler.ProfilerActivity.CPU]
    spans.intervals.clear()
    spans.profiling = True
    try:
        with torch.profiler.profile(activities=act) as prof:
            rec, _ = runner.run()
    finally:
        spans.profiling = False
    t0 = time.perf_counter()
    p = reduce_profile(prof.profiler.kineto_results.events(), spans.intervals,
                       *rec["t_ns"])
    print(f"profiled case {rec['wall_s']:.3f} s, reduced in "
          f"{time.perf_counter() - t0:.1f} s; device busy {p.busy_s:.3f} s",
          file=sys.stderr, flush=True)
    if rec.get("folder"):
        shutil.rmtree(rec["folder"], ignore_errors=True)
    return p


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result: dict) -> int:
    """Print the checks to standard error and the result line last;
    nonzero and no result when JAX or the JAX package is loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr, flush=True)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result = run_cell(args)
    except (RunError, ImportError, OSError, KeyError) as e:
        print(f"portbench: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        return 2
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
