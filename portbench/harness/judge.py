"""The comparison that decides ``correct``.

Three numbers, each the worst over the judged cases:

- ``residual``: ||F(w)||_2 of the served velocity and pressure in the
  discrete problem worked out again by ``reference/channel.py`` (the
  Dirichlet rows are w - g).  The configuration's SNES tolerances are
  rtol = atol = 1e-8 on this norm.
- ``trace_end_err``: the largest distance (max norm, in channel units)
  between an answer of the program's trace and the reference's: every
  kept forward endpoint, the reverse seed grid's corners, and the
  reverse endpoints of a sample of the seed grid drawn from the run's
  seed.  A kept forward count that differs, or an outlet point that the
  reference puts on the other side of the ring's inner edge by more than
  ``outlet_band`` (the image's edge against the program's smoothed
  contour), counts as 1.0.
- ``geometry_err``: the largest relative gap between the served meshes
  and the image the harness drew (``images.region_areas``, by its
  pixels): the areas of the inner and the outer inlet meshes, and the
  splitter's void in the channel (its cross-section times
  ``x_extrude``: the channel's box less the served mesh's volume).

The residual and the trace are worked out on the program's meshes, which
``geometry_err`` holds to the image by itself.  The trace is judged on the served velocity: the reference follows the
program from the field it served, which ``residual`` judges by itself.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import channel, tracer
from . import images

MARK = 10.0        # the upstream's endpoint of a reverse trace not back past x_keep


@dataclasses.dataclass
class CaseOutput:
    """What one case served, copied to the host."""

    Re: float
    ratio: float
    size: int
    r_inner: float
    r_outer: float
    points: np.ndarray
    cells: np.ndarray
    u: np.ndarray
    p: np.ndarray
    inlet1: tuple                 # (points2d, tris) of the inner inlet mesh
    inlet2: tuple
    fwd_seeds: np.ndarray         # (n, 3) forward seeds
    fwd_kept: np.ndarray          # (m, 3) kept forward endpoints
    rev_seeds: np.ndarray         # (N, 3) reverse seed grid
    rev_end: np.ndarray           # (N, 3) reverse endpoints
    outlet: np.ndarray            # (k, 2) outlet points


@dataclasses.dataclass
class Answers:
    """The trace's answers that are judged."""

    fwd_kept: np.ndarray
    corners: np.ndarray           # (4,) y min, y max, z min, z max of the grid
    rev_end: np.ndarray           # (s, 3) the sample's endpoints
    inside: np.ndarray            # (s,) the sample's outlet membership


def _params(cfg: dict) -> tracer.TraceParams:
    t = cfg["trace"]
    return tracer.TraceParams(t["t_max"], t["max_step"], t["speed_eps"],
                              t["rtol"], t["atol"], t["max_steps"])


def expand_bbox(y: np.ndarray, z: np.ndarray, blurr: float) -> np.ndarray:
    """The upstream's outward push of the extremes (streamtrace.py:317-343):
    the min and the max element of each axis scaled, then the axis's new
    extremes."""
    out = []
    for arr in (np.array(y, dtype=np.float64), np.array(z, dtype=np.float64)):
        i = int(np.argmin(arr))
        if arr.min() <= 0 <= arr.max():
            arr[i] = -abs(arr[i] * blurr) - abs(arr[i])
        else:
            arr[i] = arr[i] - arr[i] * blurr
        j = int(np.argmax(arr))
        arr[j] = arr[j] + arr[j] * blurr
        out += [arr.min(), arr.max()]
    return np.array(out)


def program_answers(c: CaseOutput, sample: np.ndarray) -> Answers:
    outlet = {tuple(r) for r in np.asarray(c.outlet).tolist()}
    inside = np.array([tuple(r) in outlet
                       for r in c.rev_seeds[sample, 1:3].tolist()], bool)
    g = c.rev_seeds
    corners = np.array([g[:, 1].min(), g[:, 1].max(), g[:, 2].min(),
                        g[:, 2].max()])
    return Answers(c.fwd_kept, corners, c.rev_end[sample], inside)


def reference_answers(c: CaseOutput, cfg: dict, sample: np.ndarray, device,
                      dtype=torch.float64) -> Answers:
    t = cfg["trace"]
    prm = _params(cfg)
    field = tracer.Field(c.points, c.cells, c.u, dtype, device)
    fwd = tracer.trace(field, c.fwd_seeds, 1.0, t["x_forward_stop"], 1.0,
                       prm).double().cpu().numpy()
    kept = fwd[fwd[:, 0] > t["x_forward_keep"]]
    corners = expand_bbox(kept[:, 1], kept[:, 2], t["blurr"])
    rev = tracer.trace(field, c.rev_seeds[sample], -1.0, t["x_reverse_stop"],
                       -1.0, prm).double().cpu().numpy()
    rev = np.where((rev[:, 0] < t["x_forward_keep"])[:, None], rev, MARK)
    centre, radius = images.inner_circle(c.size, c.r_inner)
    inside = np.hypot(*(rev[:, 1:3] - centre).T) < radius
    return Answers(kept, corners, rev, inside)


def answer_error(got: Answers, ref: Answers, c: CaseOutput, band: float
                 ) -> float:
    if len(got.fwd_kept) != len(ref.fwd_kept):
        return 1.0
    err = [np.abs(got.fwd_kept - ref.fwd_kept).max(initial=0.0),
           np.abs(got.corners - ref.corners).max(),
           np.abs(got.rev_end - ref.rev_end).max(initial=0.0)]
    centre, radius = images.inner_circle(c.size, c.r_inner)
    dist = np.abs(np.hypot(*(ref.rev_end[:, 1:3] - centre).T) - radius)
    if ((got.inside != ref.inside) & (dist > band)).any():
        err.append(1.0)
    return float(max(err))


def _tri_area(points: np.ndarray, tris: np.ndarray) -> float:
    a, b, c = (points[tris[:, k]] for k in range(3))
    u, v = b - a, c - a
    return 0.5 * float(np.abs(u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]).sum())


def _tet_volume(points: np.ndarray, tets: np.ndarray,
                block: int = 1 << 18) -> float:
    vol = 0.0
    for i in range(0, len(tets), block):
        t = tets[i:i + block]
        a = points[t[:, 0]]
        d = np.cross(points[t[:, 2]] - a, points[t[:, 3]] - a)
        vol += float(np.abs(np.einsum("ij,ij->i", points[t[:, 1]] - a,
                                      d)).sum()) / 6.0
    return vol


def geometry_error(c: CaseOutput, cfg: dict) -> float:
    ch = cfg["channel"]
    a_in, a_out, a_ring = images.region_areas(c.size, c.r_inner, c.r_outer,
                                              ch["half_width"])
    box = (2 * ch["half_width"]) ** 2 * ch["x_outlet"]
    got = [_tri_area(*c.inlet1), _tri_area(*c.inlet2),
           box - _tet_volume(np.asarray(c.points, np.float64),
                             np.asarray(c.cells))]
    want = [a_in, a_out, ch["x_extrude"] * a_ring]
    return float(max(abs(g - w) / w for g, w in zip(got, want)))


def sample_of(c: CaseOutput, rng: np.random.Generator, k: int) -> np.ndarray:
    n = len(c.rev_seeds)
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def judge(outputs: List[CaseOutput], cfg: dict, limits: dict,
          rng: np.random.Generator, device,
          control_trace_dtype: Optional[torch.dtype] = None,
          per_case: Optional[list] = None) -> Dict[str, float]:
    """The numbers of the judged cases (each case's pair is appended to
    ``per_case`` when given).  With ``control_trace_dtype`` the trace's
    answers judged are the reference's own in that type (the control of
    the trace) instead of the program's."""
    res, terr, geo = 0.0, 0.0, 0.0
    x_out = cfg["channel"]["x_outlet"]
    for c in outputs:
        r = channel.residual_norm(c.points, c.cells, c.u, c.p, c.Re, c.ratio,
                                  x_out, c.inlet1, c.inlet2, device)
        res = max(res, r if np.isfinite(r) else np.inf)
        s = sample_of(c, rng, limits["reverse_sample"])
        ref = reference_answers(c, cfg, s, device)
        got = (program_answers(c, s) if control_trace_dtype is None else
               reference_answers(c, cfg, s, device, control_trace_dtype))
        e = answer_error(got, ref, c, limits["outlet_band"])
        terr = max(terr, e)
        g = geometry_error(c, cfg)
        geo = max(geo, g if np.isfinite(g) else np.inf)
        if per_case is not None:
            per_case.append({"residual": r, "trace_end_err": e,
                             "geometry_err": g})
    return {"residual": res, "trace_end_err": terr, "geometry_err": geo}
