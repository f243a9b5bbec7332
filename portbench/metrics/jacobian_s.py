"""Jacobian assembly per case (s): host time inside the benchmark's span
around ``solve.driver.matrix_values_layered``."""


def read(run):
    vals = [r["spans"].get("jacobian", 0.0) for r in run.records]
    return sum(vals) / len(vals) if vals and any(vals) else None
