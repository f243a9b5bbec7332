"""Driver of ``apps/inlet_batch.py::run_trace_save``: the solve, the
checkpoint round trip, the trace and the figures of one case.

A driver is found by the ``entry`` of a traffic file and gives the
harness two functions: ``run`` makes the case's call, which the harness
times, and ``collect`` turns what it returned into the case's record,
the answers the judge compares (``judge.CaseOutput``) and the state
that the next case starts from.  The solve runs in the configuration's
``dtype`` with its ``refine`` setting, passed to the program's
``solve_ns_flow`` explicitly.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

PKG = "stabilized_navier_stokes_flow_fenicsx_tpu_torch"


def run(case, image: str, cfg: dict, device, warm):
    """One call of ``run_trace_save``; returns (solution, trace result,
    output folder)."""
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


def collect(served, case, captured: dict, workdir: str):
    """(record fields, ``CaseOutput``, the next case's ``warm``)."""
    from portbench.harness.judge import CaseOutput

    sol, res, folder = served
    fields = dict(converged=bool(sol.converged),
                  timings=dict(sol.timings), stats=dict(res.stats),
                  history={k: v.tolist() for k, v in
                           sol.newton_history.items()},
                  stokes_iters=int(sol.stokes_iters),
                  folder=os.path.join(workdir, folder))
    in1, in2 = captured["inlet_profiles"]
    seeds = captured["seed_profiles"][0].mesh.points[:, :2]
    # the served arrays themselves: each case makes new ones
    out = CaseOutput(
        Re=case.Re, ratio=case.ratio, size=case.size,
        r_inner=case.r_inner, r_outer=case.r_outer,
        points=sol.mesh.points, cells=sol.mesh.cells, u=sol.u, p=sol.p,
        inlet1=(in1.mesh.points[:, :2], in1.mesh.cells),
        inlet2=(in2.mesh.points[:, :2], in2.mesh.cells),
        fwd_seeds=np.hstack([np.zeros((len(seeds), 1)), seeds]),
        fwd_kept=res.forward_endpoints, rev_seeds=res.seeds,
        rev_end=res.reverse_endpoints, outlet=res.outlet_points)
    return fields, out, sol
