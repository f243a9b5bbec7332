"""XDMF + HDF5 solution I/O (ParaView-compatible).

Replaces ``dolfinx.io.XDMFFile`` writes (reference
NavierStokes/NavierStokesChannelFlow.py:316-346: two files per run,
functions named "Pressure"/"Velocity") and the h5py + adios4dolfinx
re-read path (reference streamtrace.py:58-130).  The HDF5 layout keeps the
reference reader's ``Function/<name>/0`` dataset path, so the solution
files double as checkpoints: solve and streamtrace can run as separate
jobs exactly like the reference (streamtrace.py:667-690).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..mesh.core import SimplexMesh

_TOPOLOGY_TYPE = {"triangle": "Triangle", "tetrahedron": "Tetrahedron"}

_XDMF_TEMPLATE = """<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0" xmlns:xi="https://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="{topo}" NumberOfElements="{nc}" NodesPerElement="{nv}">
        <DataItem Dimensions="{nc} {nv}" NumberType="Int" Format="HDF">{h5}:/Mesh/mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="{geom}">
        <DataItem Dimensions="{nn} {gd}" Format="HDF">{h5}:/Mesh/mesh/geometry</DataItem>
      </Geometry>
      <Attribute Name="{name}" AttributeType="{atype}" Center="Node">
        <DataItem Dimensions="{nn} {vs}" Format="HDF">{h5}:/Function/{name}/0</DataItem>
      </Attribute>
    </Grid>
  </Domain>
</Xdmf>
"""


def write_xdmf_function(
    basename: str,
    mesh: SimplexMesh,
    values: np.ndarray,
    name: str,
) -> str:
    """Write <basename>.xdmf + <basename>.h5 with one nodal function."""
    import os

    import h5py

    values = np.asarray(values, dtype=np.float64)
    if values.ndim == 1:
        values = values[:, None]
    vs = values.shape[1]
    h5name = basename + ".h5"
    with h5py.File(h5name, "w") as f:
        f.create_dataset("Mesh/mesh/topology",
                         data=mesh.cells.astype(np.int64))
        f.create_dataset("Mesh/mesh/geometry", data=mesh.points)
        f.create_dataset(f"Function/{name}/0", data=values)
    xml = _XDMF_TEMPLATE.format(
        topo=_TOPOLOGY_TYPE[mesh.cell],
        nc=mesh.n_cells,
        nv=mesh.cells.shape[1],
        nn=mesh.n_nodes,
        gd=mesh.gdim,
        geom="XYZ" if mesh.gdim == 3 else "XY",
        name=name,
        atype="Vector" if vs > 1 else "Scalar",
        vs=vs,
        h5=os.path.basename(h5name),
    )
    with open(basename + ".xdmf", "w") as f:
        f.write(xml)
    return basename + ".xdmf"


def read_xdmf_function(basename: str, name: str
                       ) -> Tuple[SimplexMesh, np.ndarray]:
    """Read (mesh, nodal values) back — the reference's
    read_mesh_and_function (streamtrace.py:58-130), minus the MPI
    redistribution dance (single address space)."""
    import h5py

    with h5py.File(basename + ".h5", "r") as f:
        topo = np.asarray(f["Mesh/mesh/topology"])
        geom = np.asarray(f["Mesh/mesh/geometry"])
        vals = np.asarray(f[f"Function/{name}/0"])
    cell = "tetrahedron" if topo.shape[1] == 4 else "triangle"
    mesh = SimplexMesh(cell, geom, topo.astype(np.int32))
    if vals.shape[1] == 1:
        vals = vals[:, 0]
    return mesh, vals


_SERIES_GRID = """      <Grid Name="t{it}" GridType="Uniform">
        <Time Value="{t}"/>
        <Topology TopologyType="{topo}" NumberOfElements="{nc}" NodesPerElement="{nv}">
          <DataItem Dimensions="{nc} {nv}" NumberType="Int" Format="HDF">{h5}:/Mesh/mesh/topology</DataItem>
        </Topology>
        <Geometry GeometryType="{geom}">
          <DataItem Dimensions="{nn} {gd}" Format="HDF">{h5}:/Mesh/mesh/geometry</DataItem>
        </Geometry>
        <Attribute Name="{name}" AttributeType="{atype}" Center="Node">
          <DataItem Dimensions="{nn} {vs}" Format="HDF">{h5}:/Function/{name}/{it}</DataItem>
        </Attribute>
      </Grid>
"""

_SERIES_TEMPLATE = """<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0" xmlns:xi="https://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="{name}_series" GridType="Collection" CollectionType="Temporal">
{grids}    </Grid>
  </Domain>
</Xdmf>
"""


class XdmfTimeSeries:
    """ParaView-animatable temporal collection (one mesh, many steps).

    The reference writes single snapshots only; this covers the
    time-series/animation use its users reach for ParaView for
    (continuation histories, Re sweeps on one mesh).  Steps share the
    mesh datasets; each append writes ``Function/<name>/<i>`` and
    rewrites the small XML index, so the file pair stays valid (and
    re-readable as a checkpoint via ``read_xdmf_function`` step 0)
    after every step — crash-safe like the reference's write-then-trace
    flow."""

    def __init__(self, basename: str, mesh: SimplexMesh, name: str):
        import h5py

        self.basename = basename
        self.name = name
        self.mesh = mesh
        self.times = []
        self._h5 = h5py.File(basename + ".h5", "w")
        self._h5.create_dataset("Mesh/mesh/topology",
                                data=mesh.cells.astype(np.int64))
        self._h5.create_dataset("Mesh/mesh/geometry", data=mesh.points)
        self._vs = None

    def append(self, values: np.ndarray, t: float) -> None:
        values = np.asarray(values, dtype=np.float64)
        if values.ndim == 1:
            values = values[:, None]
        self._vs = values.shape[1]
        it = len(self.times)
        self._h5.create_dataset(f"Function/{self.name}/{it}", data=values)
        self._h5.flush()
        self.times.append(float(t))
        self._write_xml()

    def _write_xml(self) -> None:
        import os

        mesh = self.mesh
        grids = "".join(
            _SERIES_GRID.format(
                it=i, t=t,
                topo=_TOPOLOGY_TYPE[mesh.cell],
                nc=mesh.n_cells, nv=mesh.cells.shape[1],
                nn=mesh.n_nodes, gd=mesh.gdim,
                geom="XYZ" if mesh.gdim == 3 else "XY",
                name=self.name,
                atype="Vector" if self._vs > 1 else "Scalar",
                vs=self._vs,
                h5=os.path.basename(self.basename + ".h5"))
            for i, t in enumerate(self.times))
        with open(self.basename + ".xdmf", "w") as f:
            f.write(_SERIES_TEMPLATE.format(name=self.name, grids=grids))

    def close(self) -> None:
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_xdmf_series(basename: str, name: str
                     ) -> Tuple[SimplexMesh, np.ndarray, np.ndarray]:
    """Read (mesh, values (nt, nn, vs), times) from a series file."""
    import re

    import h5py

    with h5py.File(basename + ".h5", "r") as f:
        topo = np.asarray(f["Mesh/mesh/topology"])
        geom = np.asarray(f["Mesh/mesh/geometry"])
        keys = sorted(f[f"Function/{name}"].keys(), key=int)
        vals = np.stack([np.asarray(f[f"Function/{name}/{k}"])
                         for k in keys])
    times = [float(m.group(1)) for m in re.finditer(
        r'<Time Value="([^"]+)"', open(basename + ".xdmf").read())]
    cell = "tetrahedron" if topo.shape[1] == 4 else "triangle"
    mesh = SimplexMesh(cell, geom, topo.astype(np.int32))
    return mesh, vals, np.asarray(times)
