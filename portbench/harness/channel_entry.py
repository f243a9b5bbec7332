"""What the channel's entries share (``drivers/run_trace_save.py`` and
``drivers/streamtrace_cli.py``): the check that the program runs as a
channel configuration states, the case stream of ``traffic.py``, the
solve's call through ``apps/inlet_batch.py::run_trace_save``, its
record and the answers the judge compares, and the control.

The solve runs in the configuration's ``dtype`` with its ``refine``
setting, passed to the program's ``solve_ns_flow`` explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import RunError, traffic

PKG = "stabilized_navier_stokes_flow_fenicsx_tpu_torch"

cases = traffic.cases
round_length = traffic.round_length
judge_rng = traffic.judge_rng


def check_program(cfg: dict) -> None:
    """The program runs as the configuration states, or the run stops.
    (The solve's ``dtype`` and ``refine`` are the driver's to pass.)"""
    import inspect

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch import config
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow import channel

    s = config.DEFAULT.solver
    t = config.DEFAULT.trace
    want = {
        "newton_rtol": (s.newton_rtol, cfg["snes"]["rtol"]),
        "newton_atol": (s.newton_atol, cfg["snes"]["atol"]),
        "coarse_lc": (inspect.signature(channel.solve_ns_flow)
                      .parameters["coarse_lc"].default, cfg["coarse_lc"]),
        "C_I": (config.DEFAULT.stab.C_I, cfg["C_I"]),
        "x_outlet": (config.DEFAULT.channel.x_outlet,
                     cfg["channel"]["x_outlet"]),
    }
    for k in ("t_max", "max_step", "speed_eps", "rtol", "atol", "max_steps",
              "x_forward_stop", "x_reverse_stop", "x_forward_keep", "blurr"):
        key = {"t_max": "t_span"}.get(k, k)
        want[f"trace.{k}"] = (getattr(t, key), cfg["trace"][k])
    off = {k: v for k, v in want.items() if v[0] != v[1]}
    if off:
        raise RunError(f"the program departs from the configuration: {off}")


def control_edit() -> dict:
    """The control: the nearest precision below the configuration's
    float64, the program's own float32 solve with refinement off, and
    in the trace's place the reference tracer in float32."""
    import torch

    return {"dtype": "float32", "refine": "off", "trace_dtype": torch.float32}


def run_trace_save(case, image: str, cfg: dict, device, warm):
    """One call of ``run_trace_save`` on the case's image; returns
    (solution, trace result, output folder)."""
    import importlib

    import torch

    inlet_batch = importlib.import_module(f"{PKG}.apps.inlet_batch")
    solve = inlet_batch.solve_ns_flow
    dtype = getattr(torch, cfg["dtype"])

    def solve_as_configured(Re, img, ratio, lc, pcfg, **kw):
        pcfg = dataclasses.replace(pcfg, solver=dataclasses.replace(
            pcfg.solver, refine=cfg["refine"]))
        return solve(Re, img, ratio, lc, pcfg, dtype=dtype, **kw)

    inlet_batch.solve_ns_flow = solve_as_configured
    try:
        return inlet_batch.run_trace_save(
            case.Re, image, case.ratio, cfg["lc"],
            num_seeds=cfg["trace"]["grid"], warm=warm, device=device)
    finally:
        inlet_batch.solve_ns_flow = solve


def solve_fields(sol, res, case) -> dict:
    """The record's fields of a ``run_trace_save`` case."""
    return dict(Re=case.Re, converged=bool(sol.converged),
                timings=dict(sol.timings), stats=dict(res.stats),
                history={k: v.tolist() for k, v in
                         sol.newton_history.items()},
                stokes_iters=int(sol.stokes_iters))


def solve_output(sol, res, case, captured: dict):
    """The ``judge.CaseOutput`` of a ``run_trace_save`` case."""
    from .judge import CaseOutput

    in1, in2 = captured["inlet_profiles"]
    seeds = captured["seed_profiles"][0].mesh.points[:, :2]
    # the served arrays themselves: each case makes new ones
    return CaseOutput(
        Re=case.Re, ratio=case.ratio, size=case.size,
        r_inner=case.r_inner, r_outer=case.r_outer,
        points=sol.mesh.points, cells=sol.mesh.cells, u=sol.u, p=sol.p,
        inlet1=(in1.mesh.points[:, :2], in1.mesh.cells),
        inlet2=(in2.mesh.points[:, :2], in2.mesh.cells),
        fwd_seeds=np.hstack([np.zeros((len(seeds), 1)), seeds]),
        fwd_kept=res.forward_endpoints, rev_seeds=res.seeds,
        rev_end=res.reverse_endpoints, outlet=res.outlet_points)
