"""Driver of ``apps/dfg3d.py``'s layered route: DFG 3D-1Z solved from
rest through the viscosity ladder, then Cd and Cl, one solve a case.

The functions a driver gives the harness are listed in
``drivers/run_trace_save.py``.  Case 0, the untimed warm-up, builds the
problem once (``setup_dfg3d``: mesh, layered pattern, BCs, multigrid
hierarchy) and solves it; every case after it is one
``solve_dfg3d_from_rest`` on that problem (the program's own ``case``
span), from rest each time.  Every case is the same work for every seed,
one a round; the judge holds every case of the window in full, so the
seed changes nothing of the run.

The judge (``reference/dfg3d.py`` on the served mesh and state):

- ``residual``: ||F(w)||_2 at nu = 0.001 with the Dirichlet rows w - g;
- ``force_err``: the larger gap between the program's Cd and Cl and the
  reference's reaction force at the served state;
- ``cd_lit_err``: the reference's Cd against 6.18533, relative;
- ``cl_band``: the reference's Cl against the band [Cl_lit / 3,
  3.5 Cl_lit], as max(low / Cl, Cl / high): 1 or less inside, inf for
  Cl <= 0.

The control (``control_edit()``) is the program's own float32 solve of
the same ladder, the nearest precision below the configuration's.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools

import numpy as np

from portbench.harness import RunError

PKG = "stabilized_navier_stokes_flow_fenicsx_tpu_torch"
TRAFFIC_KEYS = ("entry",)
LIMIT_KEYS = ("residual", "force_err", "cd_lit_err", "cl_band")


@dataclasses.dataclass(frozen=True)
class Case:
    index: int


@dataclasses.dataclass
class Output:
    """What one case served, on the host; the mesh is the problem's."""

    points: np.ndarray
    cells: np.ndarray
    u: np.ndarray
    p: np.ndarray
    cd: float
    cl: float


def _app():
    return importlib.import_module(f"{PKG}.apps.dfg3d")


def check_program(cfg: dict) -> None:
    """The program has the set-up and the solve from rest, and its
    problem is the configuration's, or the run stops."""
    app = _app()
    missing = [f for f in ("setup_dfg3d", "solve_dfg3d_from_rest")
               if not hasattr(app, f)]
    if missing:
        raise RunError(f"the program has no split set-up and solve from "
                       f"rest in apps/dfg3d.py (missing {missing})")
    geo, nw, ksp = cfg["geometry"], cfg["newton"], cfg["ksp"]
    want = {
        "L": (app.L, geo["L"]), "H": (app.W, geo["H"]),
        "cx": (app.CX, geo["cx"]), "cy": (app.CY, geo["cy"]),
        "r": (app.R, geo["r"]), "Um": (app.UM, cfg["Um"]),
        "nu": (app.NU, cfg["nu"]), "Uc": (app.UC, cfg["Uc"]),
        "Lc": (app.LC_REF, cfg["Lc"]),
        "ladder[-1]": (app.NU, cfg["ladder"][-1]),
        "newton.rtol": (app.NEWTON_RTOL, nw["rtol"]),
        "newton.atol": (app.NEWTON_ATOL, nw["atol"]),
        "newton.atol_last": (app.NEWTON_ATOL_LAST, nw["atol_last"]),
        "newton.max_it": (app.NEWTON_MAX_IT, nw["max_it"]),
        "ksp.restart": (app.KSP_RESTART, ksp["restart"]),
        "ksp.max_restarts": (app.KSP_MAX_RESTARTS, ksp["max_restarts"]),
    }
    off = {k: v for k, v in want.items() if not np.isclose(v[0], v[1],
                                                           rtol=1e-12)}
    if off or ksp["type"] != "fgmres":
        raise RunError(f"the program departs from the configuration: {off}")


def cases(traffic: dict, seed: int):
    """The endless stream: the same solve every case."""
    for i in itertools.count():
        yield Case(i)


def round_length(traffic: dict) -> int:
    return 1


def judge_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), 2 ** 20])


def prepare(case: Case, workdir: str) -> None:
    return None


def run(case: Case, prepared, cfg: dict, device, warm):
    """Case 0 builds the problem in the configuration's dtype; every case
    solves it from rest.  Returns (problem, result)."""
    import torch

    app = _app()
    prob = warm
    if prob is None:
        prob = app.setup_dfg3d(cfg["scale"], cfg["cyl_factor"],
                               cfg["near_growth"], cfg["mg_levels"],
                               dtype=getattr(torch, cfg["dtype"]),
                               device=device)
    return prob, app.solve_dfg3d_from_rest(
        prob, ladder=tuple(cfg["ladder"]), ksp_rtol=cfg["ksp"]["rtol"],
        pc=cfg["pc"])


def collect(served, case: Case, captured: dict, workdir: str):
    """(record fields, ``Output``, the problem for the next case)."""
    prob, r = served
    fields = dict(converged=bool(r.converged), cd=r.cd, cl=r.cl,
                  rungs=list(r.rungs))
    return fields, Output(prob.mesh.points, prob.mesh.cells, r.u, r.p,
                          r.cd, r.cl), prob


def pillar_band(cfg: dict) -> float:
    """The pillar's faces lie within r + this of the axis."""
    return 0.25 * cfg["lc_cyl"] * cfg["scale"] * cfg["cyl_factor"]


def judge(outputs, cfg: dict, limits: dict, rng, device, control,
          per_case=None):
    """The worst of each number over the window's cases.  The control's
    answers are the program's own float32 solve, so the judge takes no
    notice of ``control``."""
    from portbench.reference import dfg3d as ref

    lit = cfg["literature"]
    worst = dict.fromkeys(LIMIT_KEYS, 0.0)
    problem = None
    for o in outputs:
        if problem is None:
            problem = ref.Problem(o.points, o.cells, pillar_band(cfg), device)
        e = problem.evaluate(o.u, o.p, cfg["nu"])
        lo, hi = lit["cl"] / 3.0, 3.5 * lit["cl"]
        got = {"residual": e["residual"],
               "force_err": max(abs(o.cd - e["cd"]), abs(o.cl - e["cl"])),
               "cd_lit_err": abs(e["cd"] - lit["cd"]) / lit["cd"],
               "cl_band": (max(lo / e["cl"], e["cl"] / hi) if e["cl"] > 0
                           else np.inf)}
        got = {k: (v if np.isfinite(v) else np.inf) for k, v in got.items()}
        for k, v in got.items():
            worst[k] = max(worst[k], v)
        if per_case is not None:
            per_case.append(dict(got, cd=e["cd"], cl=e["cl"]))
    return worst


def describe(record: dict, judged: dict) -> str:
    """The line of a judged case on standard error."""
    rungs = [f"nu {nu:g}: {its} steps {sum(ksp)} its |F| {fnorm:.3g} "
             f"{wall:.2f} s" for nu, its, ksp, fnorm, wall in record["rungs"]]
    return (f"case {record['index']}: {record['wall_s']:.3f} s, converged "
            f"{record['converged']}, Cd {record['cd']:.6f} Cl "
            f"{record['cl']:.6f}; " + "; ".join(rungs) + "; "
            + ", ".join(f"{k} {v:.4g}" for k, v in judged.items()))


def control_edit() -> dict:
    """The control: the program's own float32 solve of the same ladder."""
    return {"dtype": "float32"}
