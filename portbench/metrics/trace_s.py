"""The streamtrace per case (s): the program's ``locator_build_s`` +
``fwd_s`` + ``rev_s``, each ending in a synchronize."""

KEYS = ("locator_build_s", "fwd_s", "rev_s")


def read(run):
    recs = run.records
    if not recs:
        return None
    return sum(sum(r["stats"][k] for k in KEYS) for r in recs) / len(recs)
