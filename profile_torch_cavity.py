#!/usr/bin/env python3
"""How far the Ghia cavity CLI's Newton stop moves from run to run.

    python3 profile_torch_cavity.py [--runs 5] [--device cuda] \
        [--perturb 0] [--max-it 30]

Runs ``apps/lid_driven.py::solve_lid_driven(32, 100)``, the solve that
``lid_driven.main(["32", "100"])`` makes, ``--runs`` times in one process
on ``--device`` in float64.  ``--perturb e`` multiplies the Newton start
(the Stokes solution) by ``1 + e * N(0, 1)`` (seeded by the run's index),
for a device whose sums come out the same every run, as the CPU's do;
``--max-it`` caps the Newton steps (the CLI's cap is 30).

Prints, for each run, its wall, the Newton steps, ``|F|`` after each
step, the FGMRES iterations of each step, and the u_x minimum with its
relative distance to the JAX package's value at the same argv
(tests/fixtures/cli_refs.npz).  The last line is one JSON summary.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REFS = os.path.join(ROOT, "tests", "fixtures", "cli_refs.npz")
N, RE = 32, 100.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--max-it", type=int, default=30)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (
        lid_driven)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (
        SolverConfig)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    with np.load(REFS) as f:
        ref = dict(zip(f["lid_driven__keys"].tolist(),
                       f["lid_driven__values"].tolist()))
    histories = []
    newton = lid_driven.solve_newton_bcsr

    def recorded(*a, **kw):
        if args.perturb:
            w0 = a[8]
            noise = np.random.default_rng(len(histories)).standard_normal(
                w0.shape)
            a = (*a[:8], w0 * (1 + args.perturb * torch.as_tensor(
                noise, dtype=w0.dtype, device=w0.device)), *a[9:])
        r = newton(*a, **kw)
        histories.append(r.history)
        return r

    lid_driven.solve_newton_bcsr = recorded
    cfg = SolverConfig(newton_max_it=args.max_it)
    runs = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        r = lid_driven.solve_lid_driven(N, RE, solver=cfg,
                                        device=args.device)
        wall = time.perf_counter() - t0
        h = histories[-1]
        ux_min = float(r.u[:, 0].min())
        run = dict(wall_s=wall, newton_iters=int(r.newton_iters),
                   converged=bool(r.converged),
                   resnorm=[float(x) for x in h[:, 0]],
                   fgmres_iters=[int(x) for x in h[:, 2]],
                   ux_min=ux_min,
                   ux_min_rel_jax=abs(ux_min - ref["ux_min"])
                   / abs(ref["ux_min"]))
        runs.append(run)
        print(f"run {i}: {wall:.2f} s, Newton {run['newton_iters']}, |F| "
              f"{['%.3e' % x for x in run['resnorm']]}, FGMRES its "
              f"{run['fgmres_iters']}, u_x min {ux_min!r} (JAX's "
              f"{ref['ux_min']!r}, relative {run['ux_min_rel_jax']:.3e})",
              flush=True)
    summary = dict(device=str(args.device), perturb=args.perturb,
                   max_it=args.max_it,
                   jax_newton_iters=int(ref["newton_iters"]), runs=runs)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
