"""Newton per case (s): the program's ``coarse_ns`` + ``fine_ns``."""


def read(run):
    recs = run.records
    if not recs:
        return None
    return sum(r["timings"].get("coarse_ns", 0.0)
               + r["timings"].get("fine_ns", 0.0) for r in recs) / len(recs)
