"""The Stokes start per case (s): ``timings["stokes"]``, the linear solve
on the plane-GS V-cycle (K2).  Absent where the cases start warm."""


def read(run):
    vals = [r["timings"]["stokes"] for r in run.records
            if "stokes" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
