"""FGMRES iterations of the viscosity ladder per case (its): the
program's ``rung_krylov_its`` counter summed over its viscosities.
None without it."""

from portbench.harness.program_cases import counter_sum


def read(run):
    return counter_sum(run, "rung_krylov_its")
