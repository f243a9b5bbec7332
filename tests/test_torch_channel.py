"""The port's slice as a whole: the image-channel continuation solve.

``flow.channel.solve_ns_flow`` on the CPU in float64 at the CHANNEL case
(Re=10, circle, ratio 0.5, lc=0.12, single mesh) must reproduce the
stored CPU-f64 JAX solution tests/fixtures/channel_ns.npz to relative L2
< 1e-6, the bar of tests/test_parity.py.

The Reynolds-sweep warm path, ``solve_ns_flow(20, ..., warm=<the stored
Re=10 CHANNEL solution>)``, must match the JAX package's warm solve to
relative L2 < 1e-6 with Newton iterations within +-1, and skip every
coarse phase.

``SolverConfig(ksp_type="tfqmr")`` must reach TFQMR in every Newton step
of the cold and the warm path (and FGMRES in none), with the cold
solution at the same bar against the fixture; an unknown ``ksp_type``
raises before any solve.
"""

import dataclasses
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from stabilized_navier_stokes_flow_fenicsx_tpu.config import (  # noqa: E402
    DEFAULT as JAX_DEFAULT)
from stabilized_navier_stokes_flow_fenicsx_tpu.flow.channel import (  # noqa: E402
    generate_channel_mesh as jax_generate_channel_mesh,
    solve_ns_flow as jax_solve_ns_flow)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (  # noqa: E402
    DEFAULT, SolverConfig)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow import (  # noqa: E402
    channel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (  # noqa: E402
    solve_ns_flow)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    newton)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import channel_image, rel_l2  # noqa: E402


def test_channel_slice_matches_fixture(tmp_path):
    img = channel_image(tmp_path)
    sol = solve_ns_flow(CHANNEL["Re"], img, CHANNEL["ratio"],
                        channel_mesh_size=CHANNEL["lc"],
                        coarse_lc=CHANNEL["lc"], device="cpu")
    w_ref = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    assert sol.converged
    assert sol.w.shape == w_ref.shape and np.isfinite(sol.w).all()
    assert rel_l2(sol.w, w_ref) < 1e-6
    # the Newton history rows: [|F|, lambda, FGMRES its, FGMRES |r|]
    hist = sol.newton_history[f"coarse_ns_Re{CHANNEL['Re']:g}"]
    assert hist.shape[1] == 4 and (hist[:, 2] > 0).all()


def test_double_float_refinement_is_not_ported(tmp_path):
    cfg = DEFAULT.__class__(solver=SolverConfig(refine="on"))
    with pytest.raises(NotImplementedError):
        solve_ns_flow(10.0, channel_image(tmp_path), 0.5, cfg=cfg,
                      device="cpu")


def test_warm_sweep_path_matches_jax(tmp_path):
    img = channel_image(tmp_path)
    mesh, _, _ = jax_generate_channel_mesh(img, CHANNEL["lc"], JAX_DEFAULT,
                                           layered=True)
    # the stored Re=10 solution as the previous rung of a sweep
    warm = types.SimpleNamespace(
        mesh=mesh, w=np.load(FIXTURE_DIR / "channel_ns.npz")["w"])
    sol = solve_ns_flow(20.0, img, CHANNEL["ratio"],
                        channel_mesh_size=CHANNEL["lc"], warm=warm,
                        device="cpu")
    ref = jax_solve_ns_flow(20.0, img, CHANNEL["ratio"],
                            channel_mesh_size=CHANNEL["lc"], warm=warm)
    assert sol.converged and bool(ref.converged)
    assert abs(sol.newton_iters - int(ref.newton_iters)) <= 1
    assert rel_l2(sol.w, np.asarray(ref.w)) < 1e-6
    assert rel_l2(sol.w, warm.w) > 1e-3          # Re=20 moved the field
    assert set(sol.timings) == {"inlet_profiles", "fine_mesh",
                                "fine_setup", "fine_ns"}
    assert sol.stokes_iters == 0 and list(sol.newton_history) == ["fine_ns"]


def test_warm_path_declines_another_mesh(tmp_path):
    """A warm solution on another mesh shape is refused (the caller
    falls back to the full continuation solve)."""
    img = channel_image(tmp_path)
    mesh, _, _ = jax_generate_channel_mesh(img, 0.2, JAX_DEFAULT,
                                           layered=True)
    warm = types.SimpleNamespace(mesh=mesh, w=None)
    timings = {}
    assert channel._solve_ns_flow_warm(
        20.0, img, None, None, CHANNEL["lc"], DEFAULT, None, "cpu", warm,
        timings) is None
    assert set(timings) == {"fine_mesh"}


def test_tfqmr_reaches_cold_and_warm_newton(tmp_path, monkeypatch):
    img = channel_image(tmp_path)
    matvecs = []
    tfqmr = newton.tfqmr

    def counting_tfqmr(*args, **kwargs):
        out = tfqmr(*args, **kwargs)
        matvecs.append(out.iters)
        return out

    def no_fgmres(*args, **kwargs):
        raise AssertionError("the Newton step ran FGMRES")

    monkeypatch.setattr(newton, "tfqmr", counting_tfqmr)
    monkeypatch.setattr(newton, "fgmres", no_fgmres)
    # TFQMR is not flexible: it takes the fixed linear V-cycle on f64
    # values (config.py's ksp_type note).  Under the bf16 one it hits its
    # matvec budget on some Newton steps from one Stokes start and not from
    # another a few 1e-8 away
    cfg = dataclasses.replace(DEFAULT, solver=SolverConfig(
        ksp_type="tfqmr", pc_newton="mg_cheby"))
    sol = solve_ns_flow(CHANNEL["Re"], img, CHANNEL["ratio"],
                        channel_mesh_size=CHANNEL["lc"],
                        coarse_lc=CHANNEL["lc"], cfg=cfg, device="cpu")
    w_ref = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    assert sol.converged and rel_l2(sol.w, w_ref) < 1e-6
    steps = np.concatenate([h[:, 2] for h in sol.newton_history.values()])
    assert len(steps) > 0 and matvecs == steps.tolist()

    matvecs.clear()
    sol20 = solve_ns_flow(20.0, img, CHANNEL["ratio"],
                          channel_mesh_size=CHANNEL["lc"], cfg=cfg,
                          warm=sol, device="cpu")
    assert sol20.converged and "coarse_ns" not in sol20.timings
    assert matvecs == sol20.newton_history["fine_ns"][:, 2].tolist()
    assert len(matvecs) == sol20.newton_iters > 0
    assert rel_l2(sol20.w, sol.w) > 1e-3          # Re=20 moved the field


def test_unknown_ksp_type_raises(tmp_path):
    cfg = DEFAULT.__class__(solver=SolverConfig(ksp_type="gmres"))
    with pytest.raises(ValueError, match="ksp_type='gmres'"):
        solve_ns_flow(10.0, channel_image(tmp_path), 0.5, cfg=cfg,
                      device="cpu")
