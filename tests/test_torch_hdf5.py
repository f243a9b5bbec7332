"""The port's HDF5 reader and writer (``io/hdf5.py``) against h5py, and
the port's XDMF I/O against the JAX package's, on the CPU.

* The port writes, h5py reads: float64, float32, int64 and int32, 1-D and
  2-D shapes with sides of length 1, nested groups; bitwise.  Parametrised
  cases and one hypothesis test over shapes, dtypes and paths.
* h5py writes (default library version bounds), the port reads; bitwise,
  including a group of more entries than one B-tree node holds.
* The JAX package's ``write_xdmf_function`` read by the port's
  ``read_xdmf_function`` and the reverse, on the CHANNEL mesh with the
  stored Re=10 velocity: bitwise, and the same ``.xdmf`` text.
* The port's ``XdmfTimeSeries`` past one symbol table node (8 entries):
  h5py and the JAX package's ``read_xdmf_series`` read it after every
  append.
* What the reader refuses (compressed, chunked, compact, big-endian,
  variable-length, a later superblock) raises ``ValueError`` naming the
  dataset or the file.
"""

import pathlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

h5py = pytest.importorskip("h5py")
pytest.importorskip("jax")

from stabilized_navier_stokes_flow_fenicsx_tpu.io import (  # noqa: E402
    xdmf as jax_xdmf)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh.core import (  # noqa: E402
    SimplexMesh as JaxSimplexMesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (  # noqa: E402
    DEFAULT)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (  # noqa: E402
    generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.io import (  # noqa: E402
    hdf5, xdmf)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import channel_image  # noqa: E402

DTYPES = ("float64", "float32", "int64", "int32")
SHAPES = ((1,), (7,), (1, 1), (1, 3), (5, 3), (4, 1))


def _array(rng, dtype, shape):
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


def _same(got, want):
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _h5py_read(path, names):
    with h5py.File(path, "r") as f:
        return {n: f[n][()] for n in names}


def _port_read(path, names):
    with hdf5.Hdf5Reader(path) as f:
        return {n: f.read(n) for n in names}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_writes_h5py_reads(tmp_path, dtype, shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    data = {"Mesh/mesh/topology": _array(rng, dtype, shape),
            "Mesh/mesh/geometry": _array(rng, "float64", (6, 3)),
            "Function/Velocity/0": _array(rng, dtype, shape),
            "top": _array(rng, "int32", (2,)),
            "a/b/c/d": _array(rng, dtype, shape)}
    path = str(tmp_path / "port.h5")
    hdf5.write_hdf5(path, data)
    got = _h5py_read(path, data)
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["Function", "Mesh", "a", "top"]
        assert sorted(f["Mesh/mesh"]) == ["geometry", "topology"]
    for name, want in data.items():
        _same(got[name], want)
        _same(_port_read(path, [name])[name], want)


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(st.tuples(
    st.lists(st.sampled_from("abcxyz0123"), min_size=1, max_size=3),
    st.sampled_from(DTYPES),
    st.lists(st.integers(1, 9), min_size=1, max_size=2),
    st.integers(0, 2 ** 32 - 1)), min_size=1, max_size=12))
def test_port_writes_h5py_reads_hypothesis(tmp_path_factory, specs):
    data = {}
    for parts, dtype, shape, seed in specs:
        # a dataset name ends in "_"; groups never do, so no path is both
        name = "/".join(parts[:-1] + [parts[-1] + "_"])
        data.setdefault(name, _array(np.random.default_rng(seed), dtype,
                                     tuple(shape)))
    path = str(tmp_path_factory.mktemp("hyp") / "h.h5")
    hdf5.write_hdf5(path, data)
    got = _h5py_read(path, data)
    for name, want in data.items():
        _same(got[name], want)


@pytest.mark.parametrize("count", (1, 9, 300))
@pytest.mark.parametrize("dtype", DTYPES)
def test_h5py_writes_port_reads(tmp_path, dtype, count):
    rng = np.random.default_rng(count)
    data = {f"Function/Velocity/{i}": _array(rng, dtype, (3, 2))
            for i in range(count)}
    data["Mesh/mesh/topology"] = _array(rng, "int64", (5, 4))
    data["Mesh/mesh/geometry"] = _array(rng, dtype, (1,))
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w") as f:
        for name, a in data.items():
            f.create_dataset(name, data=a)
    with hdf5.Hdf5Reader(path) as f:
        keys = f.keys("Function/Velocity")
        assert keys == sorted(keys) and len(keys) == count  # strcmp order
        for name, want in data.items():
            _same(f.read(name), want)


@pytest.fixture(scope="module")
def channel(tmp_path_factory):
    """The CHANNEL mesh and the stored Re=10 velocity on it."""
    img = channel_image(tmp_path_factory.mktemp("hdf5"))
    mesh, _, _ = generate_channel_mesh(img, CHANNEL["lc"], DEFAULT)
    w = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    u, _ = make_mixed_space(mesh, 1, 1).split(w)
    return mesh, JaxSimplexMesh(mesh.cell, mesh.points, mesh.cells), u


def _same_mesh(mesh, want):
    assert mesh.cell == want.cell
    assert np.array_equal(mesh.cells, want.cells)
    _same(mesh.points, want.points)


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_xdmf_function_crosses_packages(tmp_path, channel, writer):
    mesh, jmesh, u = channel
    base = {n: str(tmp_path / n / "Re10ChannelVelocity")
            for n in ("jax", "port")}
    for n in base:
        (tmp_path / n).mkdir()
    jax_xdmf.write_xdmf_function(base["jax"], jmesh, u, "Velocity")
    xdmf.write_xdmf_function(base["port"], mesh, u, "Velocity")
    texts = {n: pathlib.Path(b + ".xdmf").read_text()
             for n, b in base.items()}
    assert texts["port"] == texts["jax"]

    reader = xdmf if writer == "jax" else jax_xdmf
    got_mesh, got_u = reader.read_xdmf_function(base[writer], "Velocity")
    _same_mesh(got_mesh, mesh)
    _same(got_u, u)
    want = _h5py_read(base["jax"] + ".h5", ["Mesh/mesh/topology",
                                            "Mesh/mesh/geometry",
                                            "Function/Velocity/0"])
    for name, a in _port_read(base["port"] + ".h5", want).items():
        _same(a, want[name])


def test_xdmf_series_past_one_symbol_node(tmp_path, channel):
    mesh, _, u = channel
    base = str(tmp_path / "series")
    steps = []
    with xdmf.XdmfTimeSeries(base, mesh, "Velocity") as ts:
        for i in range(12):
            steps.append(u * (1.0 + 0.1 * i))
            ts.append(steps[-1], 0.5 * i)
            with h5py.File(base + ".h5", "r") as f:
                assert sorted(f["Function/Velocity"], key=int) == [
                    str(k) for k in range(i + 1)]
                _same(f[f"Function/Velocity/{i}"][()], steps[-1])
            jmesh, vals, times = jax_xdmf.read_xdmf_series(base, "Velocity")
            _same_mesh(jmesh, mesh)
            _same(vals, np.stack(steps))
            assert np.array_equal(times, 0.5 * np.arange(i + 1))
    pmesh, vals, times = xdmf.read_xdmf_series(base, "Velocity")
    _same_mesh(pmesh, mesh)
    _same(vals, np.stack(steps))
    assert np.array_equal(times, 0.5 * np.arange(12))


def _refused(f):
    f.create_dataset("fields/gzip", data=np.ones((10, 3)),
                     compression="gzip")
    f.create_dataset("fields/chunked", data=np.ones((10, 3)),
                     chunks=(5, 3))
    f.create_dataset("fields/bigendian", data=np.ones(3, ">f8"))
    f.create_dataset("fields/vlen", data=["a", "bc"],
                     dtype=h5py.string_dtype())
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    h5py.h5d.create(f.id, b"fields/compact", h5py.h5t.IEEE_F64LE,
                    h5py.h5s.create_simple((3,)), dcpl=dcpl)


@pytest.mark.parametrize("name, feature", (
    ("gzip", "filter pipeline"), ("chunked", "chunked layout"),
    ("compact", "compact layout"), ("bigendian", "big-endian"),
    ("vlen", "variable-length")))
def test_reader_refuses(tmp_path, name, feature):
    path = str(tmp_path / "refused.h5")
    with h5py.File(path, "w") as f:
        _refused(f)
    with pytest.raises(ValueError, match=f"fields/{name}: .*{feature}"):
        _port_read(path, [f"fields/{name}"])


def test_reader_refuses_later_superblock(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.ones(3)
    with pytest.raises(ValueError, match="latest.h5: superblock version"):
        _port_read(path, ["x"])
