"""K3 per case (ms): device time of the kernels named
``streamtrace_kernel`` (the trace's RK45) in the profiled case; None on
a program without K3."""

NAME = "streamtrace_kernel"


def read(run):
    p = run.profile
    if p is None:
        return None
    ms = [v * 1e3 for k, v in p.kernel_s.items() if NAME in k]
    return sum(ms) if ms else None
