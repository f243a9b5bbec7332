"""The viscosity ladder per case (s): the program's ``continuation``
span (``apps/dfg3d.py::solve_dfg3d_from_rest``: every rung's Newton,
Jacobians, FGMRES and V-cycles), inclusive.  None without it."""

from portbench.harness.program_cases import span_s


def read(run):
    return span_s(run, "continuation")
