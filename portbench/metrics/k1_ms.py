"""K1 per case (ms): device time of the kernels named
``layered_spmv_kernel`` in the profiled case."""

NAME = "layered_spmv_kernel"


def read(run):
    p = run.profile
    if p is None:
        return None
    ms = [v * 1e3 for k, v in p.kernel_s.items() if NAME in k]
    return sum(ms) if ms else None
