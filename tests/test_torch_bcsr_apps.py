"""The port's validation apps against the JAX package and its fixtures, on
the CPU in float64.

* Duct SUPS Navier-Stokes (tests/parity_fixtures.py's DUCT problem, built
  with the port's own modules) against tests/fixtures/duct_ns.npz, and
  ``lid_driven.solve_lid_driven(24, 100)`` with the fixture's solver
  settings against tests/fixtures/cavity_ns.npz: relative L2 < 1e-8, the
  JAX fixtures' own f64 regression bar (tests/test_parity.py:38-56).
* ``duct_stokes`` at (6, 12), ``stokes_channel`` at lc=0.12 and
  ``lid_driven`` at n=8, through their ``main`` (argv contract and
  printouts), against the JAX apps: relative 1e-8, the same printed lines.
* ``compare_images``: ``remove_gray_background`` and ``autocrop``
  identical to JAX on a seeded RGB image; the figure's three panels
  (simulated, overlay, abs diff) equal to those the JAX package's
  functions give (the port composes the figure with PIL, the JAX package
  with matplotlib, so the two PNGs differ outside the panels).

Refinement (``refine="on"``, float32 solves) is tests/test_torch_refine.py.
"""

import contextlib
import io
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.apps import (  # noqa: E402
    compare_images as jax_compare_images, duct_stokes as jax_duct_stokes,
    lid_driven as jax_lid_driven, stokes_channel as jax_stokes_channel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (  # noqa: E402
    compare_images, duct_stokes, lid_driven, stokes_channel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (  # noqa: E402
    SolverConfig)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (  # noqa: E402
    bc_mask, bc_vector)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (  # noqa: E402
    duct_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (  # noqa: E402
    solve_newton_bcsr)

from parity_fixtures import CAVITY, CHANNEL, DUCT, FIXTURE_DIR  # noqa: E402
from torch_cases import (  # noqa: E402
    channel_image, compare_panels, figure_panels, rel_l2)


def _printed(fn, *args, **kwargs):
    """(fn's result, its standard output lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


def test_duct_ns_matches_fixture():
    mesh = duct_mesh(DUCT["n_cross"], DUCT["n_axial"], DUCT["length"])
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, device="cpu")
    bc = duct_stokes.duct_bcs(mesh, W)
    mask = asm.vector(bc_mask(W.ndofs, bc))
    g = asm.vector(bc_vector(W.ndofs, bc))
    pat = asm.pattern
    out = solve_newton_bcsr(
        make_ns_sups_kernel("tetrahedron", 1.0 / DUCT["Re"]), asm.ndofs,
        pat.nnzb, pat.bs, pat.n_rows, asm.arrays, mask, g,
        torch.zeros(asm.ndofs, dtype=torch.float64),
        rtol=1e-10, atol=1e-10, max_it=30, ksp_rtol=1e-10)
    assert out.converged
    assert rel_l2(out.x, np.load(FIXTURE_DIR / "duct_ns.npz")["w"]) < 1e-8


def test_cavity_matches_fixture():
    cfg = SolverConfig(newton_rtol=1e-11, newton_atol=0.0, ksp_rtol=1e-10)
    r = lid_driven.solve_lid_driven(CAVITY["n"], CAVITY["Re"], solver=cfg,
                                    device="cpu")
    assert r.converged
    assert rel_l2(r.w, np.load(FIXTURE_DIR / "cavity_ns.npz")["w"]) < 1e-8


def test_duct_stokes_main_matches_jax():
    r, lines = _printed(duct_stokes.main, ["6"], device="cpu")
    r_ref, lines_ref = _printed(jax_duct_stokes.main, ["6"])
    assert r.converged and bool(r_ref.converged)
    assert abs(r.ksp_iters - r_ref.ksp_iters) <= 1
    assert rel_l2(r.u, r_ref.u) < 1e-8 and rel_l2(r.p, r_ref.p) < 1e-8
    assert lines[1:] == lines_ref[1:] and len(lines) == 3


def test_lid_driven_main_matches_jax():
    r, lines = _printed(lid_driven.main, ["8", "100"], device="cpu")
    r_ref, lines_ref = _printed(jax_lid_driven.main, ["8", "100"])
    assert r.converged and bool(r_ref.converged)
    assert r.newton_iters == r_ref.newton_iters
    assert rel_l2(r.w, r_ref.w) < 1e-8
    assert lines[1:] == lines_ref[1:]


def test_stokes_channel_main_matches_jax(tmp_path, monkeypatch):
    img = channel_image(tmp_path)
    argv = [img, str(CHANNEL["ratio"]), str(CHANNEL["lc"])]
    out = {}
    for name, app, kw in (("port", stokes_channel, {"device": "cpu"}),
                          ("jax", jax_stokes_channel, {})):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        out[name] = _printed(app.main, argv, **kw)
        assert sorted(os.listdir(".")) == [
            "StokesChannelPressure.h5", "StokesChannelPressure.xdmf",
            "StokesChannelVelocity.h5", "StokesChannelVelocity.xdmf"]
    (mesh, W, u, p), lines = out["port"]
    (mesh_j, _, u_j, p_j), lines_j = out["jax"]
    assert np.array_equal(mesh.cells, mesh_j.cells)
    assert rel_l2(u, u_j) < 1e-8 and rel_l2(p, p_j) < 1e-8
    assert lines == lines_j and len(lines) == 4


def _seeded_rgb():
    rng = np.random.default_rng(9)
    img = np.full((60, 80, 3), 128, np.uint8)          # gray background
    img += rng.integers(0, 12, size=img.shape, dtype=np.uint8)
    img[15:40, 20:55] = rng.integers(0, 255, size=(25, 35, 3),
                                     dtype=np.uint8)
    return img


def test_compare_images_matches_jax(tmp_path):
    img = _seeded_rgb()
    clean = compare_images.remove_gray_background(img)
    assert np.array_equal(clean, jax_compare_images.remove_gray_background(img))
    assert not np.array_equal(clean, img)
    crop = compare_images.autocrop(clean)
    assert np.array_equal(crop, jax_compare_images.autocrop(clean))
    assert crop.shape[:2] < img.shape[:2]

    from PIL import Image

    sim, exp = str(tmp_path / "sim.png"), str(tmp_path / "exp.png")
    Image.fromarray(img[::-1].copy()).save(sim)
    Image.fromarray(img).save(exp)
    got = compare_images.main([sim, exp, str(tmp_path / "port.png")])
    size, want = compare_panels(sim, exp)
    panels = figure_panels(got, size, compare_images.panel_boxes(size))
    for name, a, b in zip(compare_images.TITLES, panels, want):
        assert np.array_equal(a, b), name
