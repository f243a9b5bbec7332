"""The PyTorch port's host layer against the JAX package, and its purity.

On the CHANNEL image the port's mesh, BC vectors and host tables (the
layered pattern, the structured plan, the multigrid hierarchy) must be
identical (``np.array_equal``) to the JAX package's; and no file of the
port may import jax.
"""

import pathlib
import re

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (  # noqa: E402
    DEFAULT)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (  # noqa: E402
    _setup_layered, generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (  # noqa: E402
    solve_inlet_profiles)

from parity_fixtures import CHANNEL  # noqa: E402
from torch_cases import channel_image, jax_channel, numpy_fields  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "stabilized_navier_stokes_flow_fenicsx_tpu_torch"


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    img = channel_image(tmp_path_factory.mktemp("host"))
    ref = jax_channel(img)
    inlet1, inlet2 = solve_inlet_profiles(img, CHANNEL["ratio"], DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, CHANNEL["lc"], DEFAULT)
    st = _setup_layered(mesh, inlet1, inlet2, torch.float64, 3, "cpu")
    return ref, (mesh, st)


def _tensor_fields(obj) -> dict:
    return {k: v.numpy() for k, v in vars(obj).items()
            if isinstance(v, torch.Tensor)}


def _assert_equal_fields(port: dict, ref: dict, skip=()):
    names = set(ref) - set(skip)
    assert names <= set(port), names - set(port)
    for k in sorted(names):
        assert np.array_equal(port[k], ref[k]), k


def test_mesh_equal(both):
    (mesh_j, *_), (mesh_t, _) = both
    for k in ("points", "cells", "facets", "facet_markers"):
        assert np.array_equal(getattr(mesh_t, k), getattr(mesh_j, k)), k
    n2d, Lp, used = mesh_j.layered
    assert mesh_t.layered[:2] == (n2d, Lp)
    assert np.array_equal(mesh_t.layered[2], used)
    ntri, nl, keep = mesh_j.extrusion
    assert mesh_t.extrusion[:2] == (ntri, nl)
    assert np.array_equal(mesh_t.extrusion[2], keep)


def test_bc_vectors_equal(both):
    (_, _, _, mask, g, _), (_, st) = both
    assert np.array_equal(st.mask.numpy(), np.asarray(mask))
    assert np.array_equal(st.g.numpy(), np.asarray(g))


def test_layered_pattern_equal(both):
    (_, _, lp, *_), (_, st) = both
    assert (st.lp.n2d, st.lp.n_planes, st.lp.E, st.lp.bs) == \
        (lp.n2d, lp.n_planes, lp.E, lp.bs)
    ref = numpy_fields(lp.arrays)
    _assert_equal_fields(_tensor_fields(st.lp.arrays), ref, skip=("sasm",))
    counts = np.bincount(ref["row_ids"], minlength=lp.n2d)
    assert np.array_equal(st.lp.arrays.row_ptr.numpy(),
                          np.concatenate([[0], np.cumsum(counts)]))


def test_structured_plan_equal(both):
    (_, _, lp, *_), (_, st) = both
    _assert_equal_fields(_tensor_fields(st.lp.arrays.sasm),
                         numpy_fields(lp.arrays.sasm))


def test_mg_hierarchy_equal(both):
    (*_, hier), (_, st) = both
    assert st.mg.dims == hier.dims
    assert len(st.mg.levels) == len(hier.levels) >= 1
    for lv_t, lv_j in zip(st.mg.levels, hier.levels):
        _assert_equal_fields(_tensor_fields(lv_t), numpy_fields(lv_j))


_JAX_IMPORT = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b"
    r"|import\s+stabilized_navier_stokes_flow_fenicsx_tpu\b(?!_torch)"
    r"|from\s+stabilized_navier_stokes_flow_fenicsx_tpu\b(?!_torch))",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_jax_import(path):
    """The port (and the card's smoke run) never imports jax or the JAX
    package: the card's machine has no jax."""
    src = (ROOT / path).read_text()
    assert not _JAX_IMPORT.search(src), path
