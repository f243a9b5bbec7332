"""Conjugate-gradient iterations per case (its): the toy driver's
count, averaged over the window's cases."""


def read(run):
    if not run.records:
        return None
    return sum(r["its"] for r in run.records) / len(run.records)
