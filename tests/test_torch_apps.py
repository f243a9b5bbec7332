"""The port's batch apps against the JAX package's, on the CPU in float64
at the CHANNEL size (circle image, ratio 0.5, lc=0.12).

* ``inlet_batch.run_trace_save`` (solve -> XDMF -> re-read -> trace ->
  figures), warm-started from the stored Re=10 CHANNEL solution so the
  solve is one fine Newton check, with 24 x 24 reverse seeds: the same
  files as JAX's, and CSVs with the same rows to 1e-6 (the trace's
  tolerance, tests/test_torch_trace_pipeline.py).
* ``streamtrace_cli.main`` on a saved velocity: the same.
The port's apps run on the card unless given ``device="cpu"``, which
every call here passes.

* ``sweep.sweep_re`` with two rungs (``LC`` patched to 0.12, 12 x 12
  seeds, single-mesh continuation for the first rung to keep the test
  short): the second rung starts warm from the first and skips the
  coarse phases.
"""

import functools
import os
import shutil
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from stabilized_navier_stokes_flow_fenicsx_tpu.apps import (  # noqa: E402
    inlet_batch as jax_inlet_batch, streamtrace_cli as jax_streamtrace_cli)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (  # noqa: E402
    inlet_batch, streamtrace_cli, sweep)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (  # noqa: E402
    DEFAULT)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (  # noqa: E402
    generate_channel_mesh, solve_ns_flow)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.io.xdmf import (  # noqa: E402
    write_xdmf_function)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import channel_image  # noqa: E402

LC = CHANNEL["lc"]
CSVS = ("final_output.csv", "rev_seeds.csv")


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """The CHANNEL image and its stored Re=10 solution (mesh, w, u)."""
    img = channel_image(tmp_path_factory.mktemp("apps"))
    mesh, _, _ = generate_channel_mesh(img, LC, DEFAULT)
    w = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    u, _ = make_mixed_space(mesh, 1, 1).split(w)
    return img, types.SimpleNamespace(mesh=mesh, w=w, u=u)


def _assert_same_csvs(folder_t, folder_j):
    for name in CSVS:
        got = np.loadtxt(os.path.join(folder_t, name), delimiter=",")
        want = np.loadtxt(os.path.join(folder_j, name), delimiter=",")
        assert got.shape == want.shape and len(got) > 0, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=name)


def test_inlet_batch_matches_jax(stored, tmp_path, monkeypatch):
    img, warm = stored
    out = {}
    for name, app, kw in (("port", inlet_batch, {"device": "cpu"}),
                          ("jax", jax_inlet_batch, {})):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        sol, result, folder = app.run_trace_save(
            10, img, CHANNEL["ratio"], LC, num_seeds=24, warm=warm, **kw)
        assert bool(sol.converged)
        out[name] = (sol, os.path.abspath(folder))
    (sol, folder_t), (_, folder_j) = out["port"], out["jax"]
    assert "coarse_ns" not in sol.timings       # the warm path ran
    assert sorted(os.listdir(folder_t)) == sorted(os.listdir(folder_j))
    for name in ("Re10ChannelVelocity.xdmf", "Re10ChannelVelocity.h5",
                 "RunParameters.txt", "inner_contour.svg",
                 "inner_mesh.svg", "rev_trace_circle_24.svg", *CSVS):
        assert os.path.exists(os.path.join(folder_t, name)), name
    _assert_same_csvs(folder_t, folder_j)


def test_streamtrace_cli_matches_jax(stored, tmp_path):
    img, warm = stored
    base = str(tmp_path / "Re10ChannelVelocity")
    write_xdmf_function(base, warm.mesh, warm.u, "Velocity")
    folders = {}
    for name, app, kw in (("port", streamtrace_cli, {"device": "cpu"}),
                          ("jax", jax_streamtrace_cli, {})):
        (tmp_path / name).mkdir()
        img_copy = shutil.copy(img, tmp_path / name / "circle.png")
        result = app.main([str(img_copy), base, "Velocity"], **kw)
        assert len(result.seeds) == 50 * 50
        folders[name] = str(tmp_path / name)
    assert os.path.exists(os.path.join(folders["port"],
                                       "rev_trace_circle_50.svg"))
    _assert_same_csvs(folders["port"], folders["jax"])


def test_sweep_re_warm_starts_second_rung(stored, tmp_path, monkeypatch):
    img, _ = stored
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sweep, "LC", LC)
    monkeypatch.setattr(inlet_batch, "solve_ns_flow",
                        functools.partial(solve_ns_flow, coarse_lc=LC))
    runs = []

    def run_trace_save(Re, img_fname, ratio, lc, warm=None, device=None):
        sol, result, folder = inlet_batch.run_trace_save(
            Re, img_fname, ratio, lc, num_seeds=12, warm=warm, device=device)
        runs.append((Re, lc, warm, sol, result, device))
        return sol, result, folder

    monkeypatch.setattr(sweep, "run_trace_save", run_trace_save)
    sweep.main(["re", img, "10", "11"], device="cpu")
    (re1, lc1, warm1, sol1, res1, dev1), (re2, lc2, warm2, sol2, res2,
                                          dev2) = runs
    assert (re1, re2) == (10, 11) and lc1 == lc2 == LC
    assert dev1 == dev2 == "cpu"
    assert warm1 is None and warm2 is sol1
    assert "coarse_ns" in sol1.timings and "coarse_ns" not in sol2.timings
    assert sol1.converged and sol2.converged
    assert len(res1.outlet_points) > 0 and len(res2.outlet_points) > 0
    for Re in (10, 11):
        assert os.path.exists(
            f"noether_data/NSChannelFlow_RE{Re}_MeshLC012_circle/"
            "final_output.csv")
