"""Residual evaluations per case (s): the program's own ``residual``
spans (each residual of the Newton and its line search, and
``solve.driver.residual_norm_layered``), summed over each window case.
None without the program's tracer (``utils/profiling.py::cases``)."""

import importlib

NAMES = ("residual",)


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
    if not cases or not any(n in c.inclusive_s for c in cases
                            for n in NAMES):
        return None
    return sum(c.inclusive_s.get(n, 0.0) for c in cases
               for n in NAMES) / len(cases)
