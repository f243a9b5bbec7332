"""The program's own ``case`` spans (``utils/profiling.py::cases``)
that fall inside the window's records, for the per-layer readers."""

from __future__ import annotations

import importlib


def window_cases(run):
    """The program's ``case`` span inside each window record's ``t_ns``
    (the last such, in record order), or None without the program's
    tracer, without records, or where a record holds no such span."""
    try:
        prof = importlib.import_module(
            "stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling")
    except ImportError:
        return None
    if not hasattr(prof, "cases") or not run.records:
        return None
    kept, out = prof.cases(), []
    for r in run.records:
        t0, t1 = r["t_ns"]
        inside = [c for c in kept if t0 <= c.t0_ns and c.t1_ns <= t1]
        if not inside:
            return None
        out.append(inside[-1])
    return out


def span_s(run, name: str):
    """The program's ``name`` spans per window case (s, inclusive), or
    None where no case has one."""
    cases = window_cases(run)
    if not cases or not any(name in c.inclusive_s for c in cases):
        return None
    return sum(c.inclusive_s.get(name, 0.0) for c in cases) / len(cases)


def counter_sum(run, name: str):
    """The program's counter ``name`` summed over its keys, per window
    case, or None where no case moved it."""
    cases = window_cases(run)
    if not cases or not any(name in c.counters for c in cases):
        return None
    return sum(sum(c.counters.get(name, {}).values())
               for c in cases) / len(cases)
