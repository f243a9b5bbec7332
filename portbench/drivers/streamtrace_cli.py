"""Driver of ``apps/streamtrace_cli.py::main``: the upstream's standalone
trace of a saved solution (streamtrace.py:667-690), one call a case.

The image is drawn once.  Case 0, the untimed warm-up, solves it
through ``run_trace_save`` (as that entry does,
``harness/channel_entry.py``), traces the checkpoint it wrote once
through the CLI, and keeps that checkpoint at a fixed path in the run's
folder (the harness deletes the warm-up's own folder).  Every later
case is one call of ``main([image, checkpoint, "Velocity"])`` on it,
inside the program's own ``case`` span: the checkpoint read, the seed
profiles, the locator, the forward and the reverse trace (K3 on the
card) on the CLI's 50 x 50 reverse grid, and the figures.  The
functions a driver gives the harness are listed in
``drivers/run_trace_save.py``.

The judge: ``residual`` and ``geometry_err`` of the set-up solve, once,
since every case traces it; ``trace_end_err`` of every case against
one reference trace of the solve's served velocity (the answers of
``harness/judge.py``: kept forward endpoints, the grid's corners, the
sample's reverse endpoints and outlet membership), and the gap between
the case's reverse grid and the one the reference traced; a grid that
is not the CLI's 50 x 50 counts as 1.0.  The reference traces the
served velocity, not the checkpoint, so a checkpoint that reads back
wrong fails the trace.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import os

import numpy as np

from portbench.harness import channel_entry as channel
from portbench.harness import images
from portbench.harness import judge as channel_judge
from portbench.reference import channel as channel_ref

PKG = channel.PKG
GRID = 50          # the CLI's reverse grid, streamtrace.py:668
TRAFFIC_KEYS = ("entry", "image", "ratio", "reynolds", "warm_start")
LIMIT_KEYS = ("residual", "trace_end_err", "geometry_err", "reverse_sample",
              "outlet_band")

check_program = channel.check_program
cases = channel.cases
round_length = channel.round_length
judge_rng = channel.judge_rng
control_edit = channel.control_edit


@dataclasses.dataclass
class SetUp:
    """The solve that every case traces: its served output and the
    XDMF basename of its velocity checkpoint."""

    output: channel_judge.CaseOutput
    checkpoint: str


@dataclasses.dataclass
class Retrace:
    """What one call of the CLI served."""

    setup: SetUp
    fwd_kept: np.ndarray
    rev_seeds: np.ndarray
    rev_end: np.ndarray
    outlet: np.ndarray


def prepare(case, workdir: str) -> str:
    """The case's inlet image, drawn once for each annulus.  Before the
    first window case, what survived the set-up and the collection the
    harness just made is frozen, so that the collection before each case
    scans only what the window made (a full collection of the heap takes
    about a third of a case's wall)."""
    if case.index == 1:
        gc.freeze()
    path = os.path.join(workdir, f"annulus_{case.size}_{case.r_inner:.6g}_"
                                 f"{case.r_outer:.6g}.png")
    if not os.path.exists(path):
        images.make_annulus_image(path, case.size, case.r_inner, case.r_outer)
    return path


def _checkpoint(folder: str, case) -> str:
    return os.path.join(folder, f"Re{case.Re}ChannelVelocity")


def _retrace(image: str, checkpoint: str, device):
    cli = importlib.import_module(f"{PKG}.apps.streamtrace_cli")
    profiling = importlib.import_module(f"{PKG}.utils.profiling")
    with profiling.span("case"):
        return cli.main([image, checkpoint, "Velocity"], device=device)


def run(case, image: str, cfg: dict, device, warm):
    """Case 0: the set-up solve, one trace of its checkpoint and a
    collection; returns (solution, trace result, output folder).  Any
    other case: one call of the CLI on the set-up's checkpoint; returns
    (its result, the set-up)."""
    if case.index == 0:
        sol, res, folder = channel.run_trace_save(case, image, cfg, device,
                                                  None)
        _retrace(image, _checkpoint(folder, case), device)
        # the solve's device memory in reference cycles goes now, before
        # the harness resets the window's peak: otherwise what the
        # collector has not reached yet reads as the window's peak
        gc.collect()
        return sol, res, folder
    return _retrace(image, warm.checkpoint, device), warm


def collect(served, case, captured: dict, workdir: str):
    """(record fields, ``Retrace`` or None for the set-up, the
    ``SetUp`` every case traces)."""
    if case.index == 0:
        sol, res, folder = served
        keep = os.path.join(workdir, "setup")
        os.replace(os.path.join(workdir, folder), keep)
        setup = SetUp(channel.solve_output(sol, res, case, captured),
                      _checkpoint(keep, case))
        return channel.solve_fields(sol, res, case), None, setup
    res, setup = served
    fields = dict(converged=True, stats=dict(res.stats),
                  outlet_points=len(res.outlet_points))
    return fields, Retrace(setup, res.forward_endpoints, res.seeds,
                           res.reverse_endpoints, res.outlet_points), setup


def judge(outputs, cfg: dict, limits: dict, rng, device, control,
          per_case=None):
    """The set-up's ``residual`` and ``geometry_err``, and the worst
    ``trace_end_err`` of the window's cases."""
    if not outputs:
        return {"residual": 0.0, "trace_end_err": 0.0, "geometry_err": 0.0}
    first = outputs[0]
    s = first.setup.output
    r = channel_ref.residual_norm(s.points, s.cells, s.u, s.p, s.Re,
                                  s.ratio, cfg["channel"]["x_outlet"],
                                  s.inlet1, s.inlet2, device)
    g = channel_judge.geometry_error(s, cfg)
    # every case traces the same field from the same seeds: one reference
    c0 = dataclasses.replace(s, rev_seeds=first.rev_seeds)
    sample = channel_judge.sample_of(c0, rng, limits["reverse_sample"])
    ref = channel_judge.reference_answers(c0, cfg, sample, device)
    ctl = (None if control is None else channel_judge.reference_answers(
        c0, cfg, sample, device, control["trace_dtype"]))
    terr = 0.0
    for o in outputs:
        c = dataclasses.replace(s, fwd_kept=o.fwd_kept, rev_seeds=o.rev_seeds,
                                rev_end=o.rev_end, outlet=o.outlet)
        if (o.setup is not first.setup or o.rev_seeds.shape
                != first.rev_seeds.shape or len(o.rev_seeds) != GRID ** 2):
            e = 1.0
        else:
            got = (channel_judge.program_answers(c, sample) if ctl is None
                   else ctl)
            e = max(channel_judge.answer_error(got, ref, c,
                                               limits["outlet_band"]),
                    float(np.abs(o.rev_seeds - c0.rev_seeds).max()))
        terr = max(terr, e)
        if per_case is not None:
            per_case.append({"trace_end_err": e})
    return {"residual": r if np.isfinite(r) else np.inf,
            "trace_end_err": terr,
            "geometry_err": g if np.isfinite(g) else np.inf}


def describe(record: dict, judged: dict) -> str:
    """The line of a judged case on standard error."""
    return (f"case {record['index']}: {record['wall_s']:.3f} s, "
            f"{record['outlet_points']} outlet points, "
            + ", ".join(f"{k} {v:.4g}" for k, v in judged.items()))
