"""Host set-up per case (s): the program's own timings of the inlet
profiles, both meshes, both layered set-ups (the multigrid hierarchy
with them) and the coarse-to-fine interpolation."""

KEYS = ("inlet_profiles", "coarse_mesh", "coarse_setup", "fine_mesh",
        "fine_setup", "interpolate")


def read(run):
    recs = run.records
    if not recs:
        return None
    return sum(sum(r["timings"].get(k, 0.0) for k in KEYS)
               for r in recs) / len(recs)
