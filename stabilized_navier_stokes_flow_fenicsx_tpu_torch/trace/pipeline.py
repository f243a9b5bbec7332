"""Forward + reverse streamtrace pipeline (outlet-profile recovery).

Replicates reference NavierStokes/streamtrace.py:556-664
(for_and_rev_streamtrace):

  1. forward-trace the inner-inlet mesh vertices through the velocity
     field; keep endpoints past x = 0.5 (:211-218)
  2. alpha-shape (alpha=0.2) of the endpoints' (y, z); push the bbox out
     by 20% (:292-343)
  3. release a num_seeds x num_seeds grid at x = 3.9 (:346-355)
  4. reverse-trace the grid; keep endpoints that return past x < 0.5,
     else mark (10, 10, 10) (:357-383)
  5. keep seeds whose backward endpoints land inside the inlet inner
     contour — their (y, z) are the predicted outlet profile (:536-553)

The reference farms this over MPI ranks; here both traces are batched
device programs (trace/streamtrace.py) on the given torch device.  Each
step is a span (utils/profiling.py): ``contour``, ``locator``, ``rk45``
(once per direction), ``alpha_shape``, ``outlet_mask``; the ``stats``
walls are the lengths of ``locator`` and of the two ``rk45`` spans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import (DEFAULT, Config, TraceConfig, default_device,
                      default_dtype)
from ..fem.interpolate import build_trace_locator
from ..mesh.core import SimplexMesh
from ..mesh.image import get_contours, load_image, optimize_contour
from ..mesh.tri2d import points_in_polygon
from ..utils.profiling import read, span
from .alpha_shape import alpha_shape_polygon, expand_bbox
from .streamtrace import TraceConfigDevice, trace_particles

# seeds per segment call of the compacted tracer: the product's 200 x 200
# reverse grid (40,000 seeds) traces as ONE batch; larger grids are cut
# into batches of this width, which bounds the locator's gather
# intermediates (~K2 * 7 * 8 bytes per lane and velocity eval)
SEED_CHUNK = 1 << 16


@dataclasses.dataclass
class StreamtraceResult:
    forward_endpoints: np.ndarray     # (nf, 3) kept forward endpoints
    seeds: np.ndarray                 # (ns, 3) reverse seed grid
    reverse_endpoints: np.ndarray     # (ns, 3)
    outlet_points: np.ndarray         # (m, 2) predicted outlet profile (y, z)
    inner_contour: np.ndarray         # (k, 2) inlet inner contour (y, z)
    stats: dict = dataclasses.field(default_factory=dict)
    # seeds, dispatches, executed lane_steps (masked lanes included),
    # seed_steps (RK steps summed over seeds), per-phase wall seconds


def trace_config(tc: TraceConfig, reverse: bool = False
                 ) -> TraceConfigDevice:
    """Parameters of the forward trace (stops where x rises past
    ``x_forward_stop``) or of the reverse one (where x falls past
    ``x_reverse_stop``)."""
    return TraceConfigDevice(
        t_max=tc.t_span, max_step=tc.max_step, speed_eps=tc.speed_eps,
        x_stop=tc.x_reverse_stop if reverse else tc.x_forward_stop,
        stop_direction=-1 if reverse else 1,
        rtol=tc.rtol, atol=tc.atol, max_steps=tc.max_steps)


def update_contour(img_fname: str, cfg: Config = DEFAULT) -> np.ndarray:
    """Inlet inner contour as (k, 3) rows (0, y, z) — reference
    streamtrace.py:132-142."""
    gray = load_image(img_fname)
    contours = get_contours(gray, cfg.contour)
    c, _ = optimize_contour(
        contours[1], cfg.contour.fft_cutoff_inlet, cfg.contour.rdp_epsilon,
        cfg.contour.mesh_lc_frac_inlet)
    yz = c[:, [1, 0]]
    return np.hstack([np.zeros((len(yz), 1)), yz])


def for_and_rev_streamtrace(
    num_seeds: int,
    img_fname: str,
    mesh: SimplexMesh,
    u_nodal: np.ndarray,
    seed_points: np.ndarray,
    cfg: Config = DEFAULT,
    device=None,
) -> StreamtraceResult:
    """Full forward+reverse trace on ``device`` (default: the card;
    ``config.default_device`` raises without one).

    seed_points: (n, 2) (y, z) forward seeds (inner inlet mesh vertices —
    the reference re-solves the inlet profiles to get them, :190-196).
    Wall times in ``stats`` end in a device synchronize.
    """
    device = default_device() if device is None else torch.device(device)
    dtype = default_dtype()
    tc = cfg.trace
    with span("contour"):
        contour3 = update_contour(img_fname, cfg)
    inner_contour = contour3[:, 1:3]

    stats: dict = {}
    with span("locator", device) as s:
        dloc = build_trace_locator(mesh, dtype, device)
        u_dev = torch.as_tensor(np.asarray(u_nodal), dtype=dtype,
                                device=device)
    stats["locator_build_s"] = s.seconds

    def trace(seeds, reverse):
        with span("rk45") as s:
            ends = read(trace_particles(
                trace_config(tc, reverse), dloc, u_dev, seeds, reverse,
                chunk=SEED_CHUNK, stats=stats), torch.Tensor.cpu).numpy()
        stats["rev_s" if reverse else "fwd_s"] = s.seconds
        return ends

    seeds_fwd = np.hstack(
        [np.zeros((len(seed_points), 1)), seed_points])
    fwd_end = trace(seeds_fwd, False)
    kept = fwd_end[fwd_end[:, 0] > tc.x_forward_keep]

    # expansion + reverse seed grid
    with span("alpha_shape"):
        poly = alpha_shape_polygon(kept[:, 1:3], tc.alpha)
    minx, maxx, miny, maxy = expand_bbox(poly[:, 0], poly[:, 1], tc.blurr)
    ys = np.linspace(minx, maxx, num_seeds)
    zs = np.linspace(miny, maxy, num_seeds)
    Y, Z = np.meshgrid(ys, zs)
    grid = np.stack([Y.ravel(), Z.ravel()], axis=1)
    seeds_rev = np.hstack(
        [np.full((len(grid), 1), tc.x_seed_plane), grid])

    rev_end = trace(seeds_rev, True)
    # reference: endpoints not back past x=0.5 are marked (10,10,10)
    rev_end = np.where(
        (rev_end[:, 0] < tc.x_forward_keep)[:, None], rev_end, 10.0)

    with span("outlet_mask"):
        inside = points_in_polygon(rev_end[:, 1:3], inner_contour)
    outlet = seeds_rev[inside][:, 1:3]

    return StreamtraceResult(
        forward_endpoints=kept,
        seeds=seeds_rev,
        reverse_endpoints=rev_end,
        outlet_points=outlet,
        inner_contour=inner_contour,
        stats=stats,
    )
