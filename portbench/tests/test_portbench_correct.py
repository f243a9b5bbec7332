"""``correct`` at a size a CPU test holds (the tiny cells: lc 0.12, a
16 x 16 reverse grid; the retrace's CLI keeps its 50 x 50): a sound run
is correct; the control (the program's float32 solve without
refinement, the reference tracer in float32) comes out not correct,
failing the residual and the trace; and a run with the timed path
broken underneath comes out not correct, once for each fault a cell can
have.
Each run takes about a minute on the CPU."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from conftest import DATA, tiny_bench
from portbench import control
from portbench import run as bench_run

PKG = "stabilized_navier_stokes_flow_fenicsx_tpu_torch"


def _limits(cell):
    with open(os.path.join(DATA, "limits", f"{cell}.json")) as f:
        return json.load(f)


def _run(cell, seed=3_000_000_001):
    args = bench_run.parse(["--workload", cell, "--seed", str(seed),
                            "--seconds", "0", "--trace", "0"])
    return bench_run.run_cell(args, device="cpu", bench=tiny_bench(),
                              base=DATA)


@pytest.mark.parametrize("cell", ["tiny.images", "tiny.sweep",
                                  "tiny.retrace"])
def test_control_fails_sound_passes(cell):
    lim = _limits(cell)
    sound, = control.readings(cell, "sound", [11], 0, "cpu",
                              bench=tiny_bench(), base=DATA)
    ctl, = control.readings(cell, "control", [11], 0, "cpu",
                            bench=tiny_bench(), base=DATA)
    assert sound["correct"] and not ctl["correct"]
    for k in ("residual", "trace_end_err"):
        assert (sound["checks"][k]["value"] <= lim[k]
                < ctl["checks"][k]["value"]), k


def _checkpoint_altered(monkeypatch):
    """The retrace's CLI reads back a velocity with a cross flow added."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (
        streamtrace_cli)

    read = streamtrace_cli.read_xdmf_function

    def altered(*args, **kw):
        mesh, u = read(*args, **kw)
        u = u.copy()
        u[:, 1] += 1e-3
        return mesh, u
    monkeypatch.setattr(streamtrace_cli, "read_xdmf_function", altered)


def _state_unchanged(monkeypatch):
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow import channel
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.newton import (
        NewtonResult)

    def newton(*args, **kw):
        return NewtonResult(x=args[7], iters=1, resnorm=0.0, converged=True,
                            history=np.zeros((1, 4)))
    monkeypatch.setattr(channel, "solve_newton_layered", newton)


def _reverse(monkeypatch, alter):
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace import pipeline

    trace = pipeline.trace_particles

    def traced(cfg, dloc, u, seeds, reverse=False, **kw):
        if not reverse:
            return trace(cfg, dloc, u, seeds, reverse, **kw)
        return alter(lambda s: trace(cfg, dloc, u, s, reverse, **kw),
                     torch.as_tensor(seeds))
    monkeypatch.setattr(pipeline, "trace_particles", traced)


def _answer_altered(monkeypatch):
    def alter(trace, seeds):
        ends = trace(seeds).clone()
        ends[:, 1] += 2e-3
        return ends
    _reverse(monkeypatch, alter)


def _half_left_out(monkeypatch):
    def alter(trace, seeds):
        ends = seeds.clone().to(torch.float64)
        half = len(seeds) // 2
        ends[:half] = trace(seeds[:half])
        return ends
    _reverse(monkeypatch, alter)


def _field_altered(monkeypatch):
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (
        inlet_batch)

    solve = inlet_batch.solve_ns_flow

    def altered(*args, **kw):
        sol = solve(*args, **kw)
        sol.u[len(sol.u) // 2, 0] += 1e-2
        return sol
    monkeypatch.setattr(inlet_batch, "solve_ns_flow", altered)


def _mesh_altered(monkeypatch):
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow import channel

    mesh_of = channel.generate_channel_mesh

    def altered(*args, **kw):
        mesh, inner, outer = mesh_of(*args, **kw)
        mesh.points = mesh.points * np.array([1.0, 1.03, 1.03])
        return mesh, inner, outer
    monkeypatch.setattr(channel, "generate_channel_mesh", altered)


FAULTS = {"none": None, "state_unchanged": _state_unchanged,
          "answer_altered": _answer_altered, "half_left_out": _half_left_out,
          "field_altered": _field_altered, "mesh_altered": _mesh_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_makes_run_not_correct(fault, monkeypatch):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    result = _run("tiny.images")
    assert result["correct"] is (fault == "none"), result["checks"]


RETRACE_FAULTS = {"none": None, "state_unchanged": _state_unchanged,
                  "answer_altered": _answer_altered,
                  "half_left_out": _half_left_out,
                  "checkpoint_altered": _checkpoint_altered}


@pytest.mark.parametrize("fault", list(RETRACE_FAULTS))
def test_retrace_fault_makes_run_not_correct(fault, monkeypatch):
    """The retrace cell: the set-up solve left at its start, a reverse
    endpoint altered, half of the reverse seeds left untraced, or the
    checkpoint read back altered, each in the CLI's path."""
    if RETRACE_FAULTS[fault] is not None:
        RETRACE_FAULTS[fault](monkeypatch)
    result = _run("tiny.retrace")
    assert result["correct"] is (fault == "none"), result["checks"]
