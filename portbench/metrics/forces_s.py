"""The force functionals per case (s): the program's ``forces`` span
(the raw residual and the reaction summed on the device, the traction
surface integral on the host), inclusive.  None without it."""

from portbench.harness.program_cases import span_s


def read(run):
    return span_s(run, "forces")
