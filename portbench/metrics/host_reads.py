"""Blocking device->host reads per case (reads): the program's
``host_reads`` counter (``utils/profiling.py::read``: each ``float()``,
``.tolist()``, ``int()`` or ``.cpu()`` of a device tensor on the main
path, each of which drains the launch queue), summed over its spans and
averaged over the window's cases.  None without the program's tracer."""

import importlib


def window_cases(run):
    """The program's ``case`` span inside each window record's ``t_ns``
    (the last such, in record order), or None."""
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


def read(run):
    cases = window_cases(run)
    if not cases:
        return None
    return sum(sum(c.counters.get("host_reads", {}).values())
               for c in cases) / len(cases)
