"""K4 per case (ms): device time of the kernels named
``soa_jacobian_kernel`` and ``soa_residual_kernel`` (the structured
route's SoA element Jacobian and residual) in the profiled case; None on
a program without K4."""

NAMES = ("soa_jacobian_kernel", "soa_residual_kernel")


def read(run):
    p = run.profile
    if p is None:
        return None
    ms = [v * 1e3 for k, v in p.kernel_s.items()
          if any(n in k for n in NAMES)]
    return sum(ms) if ms else None
