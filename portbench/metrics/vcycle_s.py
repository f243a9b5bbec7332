"""V-cycle applies per case (s): host time inside the benchmark's span
around each apply that ``solve.mg.make_mg_pc`` returns."""


def read(run):
    vals = [r["spans"].get("vcycle", 0.0) for r in run.records]
    return sum(vals) / len(vals) if vals and any(vals) else None
