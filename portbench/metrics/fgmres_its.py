"""Krylov iterations per case (its): the Newton histories' Krylov
column summed over every solve of the case, plus the Stokes start's."""


def read(run):
    recs = run.records
    if not recs:
        return None
    return sum(sum(row[2] for rows in r["history"].values() for row in rows)
               + r["stokes_iters"] for r in recs) / len(recs)
