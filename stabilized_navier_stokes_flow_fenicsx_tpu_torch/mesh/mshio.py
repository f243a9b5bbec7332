"""Gmsh ``.msh`` ASCII interop (reader for MSH 2.2 and 4.1, writer 4.1).

The reference ships gmsh geometries for the DFG validation cases
(reference NavierStokes/Validation_Flow/dfg_pillar_2D.geo:95-99 and
dfg_pillar_3D.geo:98-102 define the physical groups fluid / inlet /
outlet / walls / obstacle) and reads meshes through
``dolfinx.io.gmshio`` (reference DFG_2D_Validation.py:28).  This module
closes the interop gap for the framework: any externally
generated gmsh mesh — including meshes produced by the reference's own
``.geo`` files — can be ingested as a :class:`SimplexMesh`, so
matched-mesh cross-validation against FEniCSx fields is possible; and
framework meshes can be exported for the reverse direction.

Physical groups on codim-1 entities become facet markers (the
``facets`` / ``facet_markers`` arrays); physical groups on cells are
returned separately as ``cell_markers``.  Only simplex elements are
supported (line / triangle / tetrahedron; gmsh types 1, 2, 4).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .core import SimplexMesh

# gmsh element type -> (name, n_nodes, dim)
_GMSH_SIMPLEX = {
    1: ("interval", 2, 1),
    2: ("triangle", 3, 2),
    4: ("tetrahedron", 4, 3),
    15: ("point", 1, 0),
}
_TYPE_OF_CELL = {"interval": 1, "triangle": 2, "tetrahedron": 4}


def _read_sections(path: str) -> Dict[str, list]:
    """Split a .msh file into named sections (list of token lines)."""
    sections: Dict[str, list] = {}
    name = None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith("$End"):
                name = None
            elif line.startswith("$"):
                name = line[1:]
                sections[name] = []
            elif name is not None:
                sections[name].append(line)
    return sections


def _parse_v2(sections) -> Tuple[np.ndarray, dict, dict]:
    """MSH 2.2: nodes + per-element (type, phys_tag, nodes)."""
    nl = sections["Nodes"]
    n_nodes = int(nl[0])
    tags = np.empty(n_nodes, np.int64)
    pts = np.empty((n_nodes, 3), np.float64)
    for i, line in enumerate(nl[1 : 1 + n_nodes]):
        t = line.split()
        tags[i] = int(t[0])
        pts[i] = [float(t[1]), float(t[2]), float(t[3])]

    el = sections["Elements"]
    n_el = int(el[0])
    by_type: Dict[int, list] = {}
    phys_by_type: Dict[int, list] = {}
    for line in el[1 : 1 + n_el]:
        t = line.split()
        etype = int(t[1])
        if etype not in _GMSH_SIMPLEX:
            continue
        ntags = int(t[2])
        phys = int(t[3]) if ntags >= 1 else 0
        nn = _GMSH_SIMPLEX[etype][1]
        nodes = [int(x) for x in t[3 + ntags : 3 + ntags + nn]]
        by_type.setdefault(etype, []).append(nodes)
        phys_by_type.setdefault(etype, []).append(phys)
    return (pts, dict(tags=tags, by_type=by_type,
                      phys_by_type=phys_by_type), {})


def _parse_v4(sections) -> Tuple[np.ndarray, dict, dict]:
    """MSH 4.1: entity blocks; physical tags come from $Entities."""
    # entity (dim, tag) -> first physical tag (0 if none)
    ent_phys: Dict[Tuple[int, int], int] = {}
    if "Entities" in sections:
        lines = sections["Entities"]
        counts = [int(x) for x in lines[0].split()]
        i = 1
        for dim, n_ent in enumerate(counts):
            for _ in range(n_ent):
                t = lines[i].split()
                i += 1
                tag = int(t[0])
                # points: tag x y z numPhys ...; curves/surfs/vols:
                # tag 6 bbox floats, numPhys, phys..., numBounding, ...
                off = 4 if dim == 0 else 7
                n_phys = int(t[off])
                phys = int(t[off + 1]) if n_phys > 0 else 0
                ent_phys[(dim, tag)] = phys

    nl = sections["Nodes"]
    hdr = [int(x) for x in nl[0].split()]
    n_blocks, n_nodes = hdr[0], hdr[1]
    tags = np.empty(n_nodes, np.int64)
    pts = np.empty((n_nodes, 3), np.float64)
    i, k = 1, 0
    for _ in range(n_blocks):
        _, _, _, nb = (int(x) for x in nl[i].split())
        i += 1
        for j in range(nb):
            tags[k + j] = int(nl[i + j])
        for j in range(nb):
            pts[k + j] = [float(x) for x in nl[i + nb + j].split()[:3]]
        i += 2 * nb
        k += nb

    el = sections["Elements"]
    hdr = [int(x) for x in el[0].split()]
    n_blocks = hdr[0]
    by_type: Dict[int, list] = {}
    phys_by_type: Dict[int, list] = {}
    i = 1
    for _ in range(n_blocks):
        edim, etag, etype, nb = (int(x) for x in el[i].split())
        i += 1
        phys = ent_phys.get((edim, etag), 0)
        if etype in _GMSH_SIMPLEX:
            nn = _GMSH_SIMPLEX[etype][1]
            for line in el[i : i + nb]:
                t = line.split()
                by_type.setdefault(etype, []).append(
                    [int(x) for x in t[1 : 1 + nn]])
                phys_by_type.setdefault(etype, []).append(phys)
        i += nb
    return (pts, dict(tags=tags, by_type=by_type,
                      phys_by_type=phys_by_type), {})


def read_msh(path: str) -> Tuple[SimplexMesh, Optional[np.ndarray]]:
    """Read a gmsh ASCII ``.msh`` (2.2 or 4.1) into a SimplexMesh.

    Returns ``(mesh, cell_markers)``.  The highest-dimensional simplex
    type becomes the cell; codim-1 elements with a nonzero physical tag
    become ``mesh.facets`` / ``mesh.facet_markers`` (vertex indices
    sorted per facet, matching mark_boundary_facets' convention).
    Geometric dimension is trimmed to 2 when all z coordinates vanish.
    """
    sections = _read_sections(path)
    if "MeshFormat" not in sections:
        raise ValueError(f"{path}: not a gmsh .msh file")
    version = float(sections["MeshFormat"][0].split()[0])
    if version >= 4.0:
        pts, data, _ = _parse_v4(sections)
    else:
        pts, data, _ = _parse_v2(sections)

    tags = data["tags"]
    remap = np.full(int(tags.max()) + 1, -1, np.int64)
    remap[tags] = np.arange(len(tags))

    by_type = data["by_type"]
    cell_type = max(
        (t for t in by_type if t != 15),
        key=lambda t: _GMSH_SIMPLEX[t][2], default=None)
    if cell_type is None:
        raise ValueError(f"{path}: no simplex cells found")
    cell_name, _, cdim = _GMSH_SIMPLEX[cell_type]
    cells = remap[np.asarray(by_type[cell_type], np.int64)].astype(np.int32)
    cell_markers = np.asarray(data["phys_by_type"][cell_type], np.int32)
    if not cell_markers.any():
        cell_markers = None

    facets = facet_markers = None
    facet_type = {3: 2, 2: 1}.get(cdim)
    if facet_type in by_type:
        fm = np.asarray(data["phys_by_type"][facet_type], np.int32)
        fv = remap[np.asarray(by_type[facet_type], np.int64)]
        keep = fm != 0
        if keep.any():
            facets = np.sort(fv[keep], axis=1).astype(np.int32)
            facet_markers = fm[keep]

    if cdim == 2 and np.allclose(pts[:, 2], 0.0):
        pts = pts[:, :2]
    mesh = SimplexMesh(cell_name, pts, cells, facets, facet_markers)
    mesh.orient_positive()
    return mesh, cell_markers


def write_msh(path: str, mesh: SimplexMesh,
              cell_markers: Optional[np.ndarray] = None) -> None:
    """Write a SimplexMesh as gmsh MSH 4.1 ASCII.

    Facet markers become codim-1 element blocks on discrete entities
    whose physical tag equals the marker; cells go on one entity of the
    cell dimension (physical tag = 1, or per-marker blocks when
    ``cell_markers`` is given).  Round-trips through :func:`read_msh`.
    """
    pts = mesh.points
    if pts.shape[1] == 2:
        pts = np.hstack([pts, np.zeros((len(pts), 1))])
    cdim = mesh.dim
    fdim = cdim - 1
    ftype = _TYPE_OF_CELL[{2: "interval", 3: "triangle"}[cdim]] \
        if cdim >= 2 else 15
    ctype = _TYPE_OF_CELL[mesh.cell]

    # group facets by marker -> one discrete entity per marker
    f_groups = []
    if mesh.facets is not None and len(mesh.facets):
        for m in np.unique(mesh.facet_markers):
            f_groups.append((int(m), mesh.facets[mesh.facet_markers == m]))
    c_groups = []
    if cell_markers is not None:
        for m in np.unique(cell_markers):
            c_groups.append((int(m), mesh.cells[cell_markers == m]))
    else:
        c_groups.append((1, mesh.cells))

    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat"]
    # entities: one per facet group at dim fdim, one per cell group
    lines.append("$Entities")
    counts = [0, 0, 0, 0]
    counts[fdim] = len(f_groups)
    counts[cdim] += len(c_groups)
    lines.append(" ".join(str(c) for c in counts))
    bb = "0 0 0 1 1 1"
    for m, _ in f_groups:
        lines.append(f"{m} {bb} 1 {m} 0")
    for m, _ in c_groups:
        lines.append(f"{m} {bb} 1 {m} 0")
    lines.append("$EndEntities")

    lines.append("$Nodes")
    n = len(pts)
    lines.append(f"1 {n} 1 {n}")
    lines.append(f"{cdim} {c_groups[0][0]} 0 {n}")
    lines.extend(str(i + 1) for i in range(n))
    lines.extend(f"{p[0]:.17g} {p[1]:.17g} {p[2]:.17g}" for p in pts)
    lines.append("$EndNodes")

    lines.append("$Elements")
    n_el = sum(len(g) for _, g in f_groups) + \
        sum(len(g) for _, g in c_groups)
    lines.append(f"{len(f_groups) + len(c_groups)} {n_el} 1 {n_el}")
    eid = 1
    for m, fv in f_groups:
        lines.append(f"{fdim} {m} {ftype} {len(fv)}")
        for f in fv:
            lines.append(
                f"{eid} " + " ".join(str(v + 1) for v in f))
            eid += 1
    for m, cv in c_groups:
        lines.append(f"{cdim} {m} {ctype} {len(cv)}")
        for c in cv:
            lines.append(
                f"{eid} " + " ".join(str(v + 1) for v in c))
            eid += 1
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
