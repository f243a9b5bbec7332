"""Checkpoint I/O, figures and the trace's host tail per case (s): the
case's wall less the solve's timings and the trace's three stats (a
remainder until the program has spans for these calls)."""

TRACE = ("locator_build_s", "fwd_s", "rev_s")


def read(run):
    recs = run.records
    if not recs:
        return None
    return sum(r["wall_s"] - sum(r["timings"].values())
               - sum(r["stats"][k] for k in TRACE) for r in recs) / len(recs)
