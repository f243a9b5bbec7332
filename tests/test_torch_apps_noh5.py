"""The port's apps with ``h5py`` and ``matplotlib`` blocked, on the CPU.

Importing either raises while an app runs (``sys.modules`` holds None
for them), as on a machine that has neither: ``inlet_batch.
run_trace_save`` (CHANNEL, warm from the stored Re=10 solution, 24 x 24
reverse seeds), ``streamtrace_cli.main``, ``ns_channel.main`` and
``compare_images.main``.  With the block lifted, h5py reads the port's
``.h5`` files and finds the in-memory fields bit for bit; every SVG
parses, and its scatter holds one marker a point: a row of the CSV
beside it for the outlet points, an inlet mesh node for the seeds.
"""

import contextlib
import os
import shutil
import sys
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("jax")

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import (  # noqa: E402
    compare_images, inlet_batch, ns_channel, streamtrace_cli)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (  # noqa: E402
    DEFAULT)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (  # noqa: E402
    generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (  # noqa: E402
    solve_inlet_profiles)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.io.xdmf import (  # noqa: E402
    write_xdmf_function)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import (  # noqa: E402
    channel_image, compare_panels, figure_panels)

LC = CHANNEL["lc"]
SVG = "{http://www.w3.org/2000/svg}"
BLOCKED = ("h5py", "matplotlib", "matplotlib.pyplot")


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """The CHANNEL image, its stored Re=10 solution (mesh, w, u) and the
    inlet mesh nodes the trace seeds from."""
    img = channel_image(tmp_path_factory.mktemp("noh5"))
    mesh, _, _ = generate_channel_mesh(img, LC, DEFAULT)
    w = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    u, _ = make_mixed_space(mesh, 1, 1).split(w)
    inlet1, _ = solve_inlet_profiles(img, CHANNEL["ratio"], DEFAULT)
    return img, types.SimpleNamespace(mesh=mesh, w=w, u=u), \
        inlet1.mesh.points


@contextlib.contextmanager
def blocked(monkeypatch):
    """Importing h5py or matplotlib raises inside this context."""
    with monkeypatch.context() as m:
        for name in BLOCKED:
            m.setitem(sys.modules, name, None)
        with pytest.raises(ImportError):
            import h5py  # noqa: F401
        yield


def _checkpoint_equals(base, name, mesh, values):
    with h5py.File(base + ".h5", "r") as f:
        topo = f["Mesh/mesh/topology"][()]
        geom = f["Mesh/mesh/geometry"][()]
        vals = f[f"Function/{name}/0"][()]
    assert topo.dtype == np.int64 and np.array_equal(topo, mesh.cells)
    assert geom.tobytes() == mesh.points.tobytes()
    want = np.asarray(values, np.float64).reshape(len(geom), -1)
    assert vals.dtype == np.float64 and vals.tobytes() == want.tobytes()
    assert os.path.exists(base + ".xdmf")


def _markers(svg):
    root = ET.parse(svg).getroot()
    group = [g for g in root.iter(f"{SVG}g") if g.get("id") == "scatter"]
    assert len(group) == 1, svg
    return len(group[0].findall(f"{SVG}circle"))


def _check_figures(folder, img_name, num_seeds, seeds, result):
    rows = np.loadtxt(os.path.join(folder, "final_output.csv"),
                      delimiter=",", ndmin=2)
    assert len(rows) == len(result.outlet_points) > 0
    rev = os.path.join(folder, f"rev_trace_{img_name}_{num_seeds}.svg")
    assert _markers(rev) == len(rows)
    assert _markers(os.path.join(folder, "inner_mesh.svg")) == len(seeds)
    contour = ET.parse(os.path.join(folder, "inner_contour.svg")).getroot()
    poly = next(contour.iter(f"{SVG}polygon"))
    assert len(poly.get("points").split()) == len(result.inner_contour)
    titles = [t.text for t in contour.iter(f"{SVG}text")]
    assert titles == ["Inner Contour"]


def test_inlet_batch_without_h5py_matplotlib(stored, tmp_path, monkeypatch):
    img, warm, seeds = stored
    monkeypatch.chdir(tmp_path)
    with blocked(monkeypatch):
        sol, result, folder = inlet_batch.run_trace_save(
            10, img, CHANNEL["ratio"], LC, num_seeds=24, warm=warm,
            device="cpu")
    assert sol.converged and "coarse_ns" not in sol.timings
    _checkpoint_equals(os.path.join(folder, "Re10ChannelVelocity"),
                       "Velocity", sol.mesh, sol.u)
    _checkpoint_equals(os.path.join(folder, "Re10ChannelPressure"),
                       "Pressure", sol.mesh, sol.p)
    _check_figures(folder, "circle", 24, seeds, result)


def test_streamtrace_cli_without_h5py_matplotlib(stored, tmp_path,
                                                 monkeypatch):
    img, warm, seeds = stored
    base = str(tmp_path / "Re10ChannelVelocity")
    img_copy = shutil.copy(img, tmp_path / "circle.png")
    with blocked(monkeypatch):
        write_xdmf_function(base, warm.mesh, warm.u, "Velocity")
        result = streamtrace_cli.main([str(img_copy), base, "Velocity"],
                                      device="cpu")
    assert len(result.seeds) == 50 * 50
    _checkpoint_equals(base, "Velocity", warm.mesh, warm.u)
    _check_figures(str(tmp_path), "circle", 50, seeds, result)


def test_ns_channel_without_h5py_matplotlib(stored, tmp_path, monkeypatch):
    img, _, _ = stored
    monkeypatch.chdir(tmp_path)
    with blocked(monkeypatch):
        sol, folder = ns_channel.main(["10", img, "0.5", str(LC)],
                                      device="cpu")
    assert sol.converged
    _checkpoint_equals(os.path.join(folder, "Re10ChannelVelocity"),
                       "Velocity", sol.mesh, sol.u)
    _checkpoint_equals(os.path.join(folder, "Re10ChannelPressure"),
                       "Pressure", sol.mesh, sol.p)


def test_compare_images_without_matplotlib(tmp_path, monkeypatch):
    from PIL import Image

    # white, and outlet-image blue (no pixel near gray, so an image
    # against itself differs nowhere)
    rng = np.random.default_rng(4)
    img = np.full((48, 64, 3), 255, np.uint8)
    img[10:30, 12:50][rng.random((20, 38)) < 0.5] = (81, 164, 209)
    sim, exp = str(tmp_path / "sim.png"), str(tmp_path / "exp.png")
    Image.fromarray(img).save(sim)
    Image.fromarray(np.roll(img, 3, axis=1)).save(exp)
    with blocked(monkeypatch):
        out = compare_images.main([sim, exp, str(tmp_path / "cmp.png")])
        same = compare_images.main([sim, sim, str(tmp_path / "same.png")])
    for png, (a, b) in ((out, (sim, exp)), (same, (sim, sim))):
        size, want = compare_panels(a, b)
        got = figure_panels(png, size, compare_images.panel_boxes(size))
        for name, g, w in zip(compare_images.TITLES, got, want):
            assert np.array_equal(g, w), (png, name)
    assert not figure_panels(same, size,
                             compare_images.panel_boxes(size))[2].any()
