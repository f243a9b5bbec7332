"""K1's share of its roofline over the profiled case (%): 100 x the
least time of every K1 launch of that case (the program's ``k1_launch``
counter by launch shape, each shape's count times
``harness/kernels.py::k1_bound``) over the device time of the kernels
named ``layered_spmv_kernel`` in the profile.  The profiled case is the
program's last ``case`` span after the window's last record.  None
without the program's tracer or without a launch."""

import importlib

from portbench.harness import kernels

COUNTER, NAME = "k1_launch", "layered_spmv_kernel"
SIZE = {"float64": 8, "float32": 4, "bfloat16": 2}


def bound_ms(shape):
    E, Lp, n2d, vdtype, adtype, masked = shape
    return kernels.k1_bound(E, Lp, n2d, SIZE[vdtype], SIZE[adtype],
                            masked)[0]


def profiled_case(run):
    """The program's last ``case`` span after the window, or None."""
    try:
        prof = importlib.import_module(
            "stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling")
    except ImportError:
        return None
    if not hasattr(prof, "cases") or not run.records or run.profile is None:
        return None
    end = run.records[-1]["t_ns"][1]
    after = [c for c in prof.cases() if c.t0_ns >= end]
    return after[-1] if after else None


def read(run):
    case = profiled_case(run)
    launches = case.counters.get(COUNTER) if case else None
    ms = sum(v * 1e3 for k, v in run.profile.kernel_s.items()
             if NAME in k) if launches else 0.0
    if ms <= 0.0:
        return None
    return 100.0 * sum(n * bound_ms(s) for s, n in launches.items()) / ms
