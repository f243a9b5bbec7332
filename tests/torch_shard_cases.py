"""Shared cases of the plane-sharded layered tests
(tests/test_torch_layered_shard*.py): the duct and CHANNEL problems built
by the JAX package and the port from the same parameters, the solver
tolerances and the rank counts.  The fixtures are imported by the test
modules; each module builds them once."""

import numpy as np
import pytest

from parity_fixtures import CHANNEL
from torch_cases import channel_image
from torch_dist_cases import channel_problem, duct_problem

import test_layered_shard as jax_cases

TOLS = dict(rtol=1e-12, atol=1e-12, max_it=30, ksp_rtol=1e-10)
RANKS = (2, 4)


@pytest.fixture(scope="module")
def img(tmp_path_factory):
    return channel_image(tmp_path_factory.mktemp("layered_shard"))


def _params(geometry, img):
    if geometry == "duct":
        return dict(geometry="duct", n_cross=6, n_axial=13, Re=20.0)
    return dict(geometry="channel", img=img, lc=CHANNEL["lc"],
                Re=CHANNEL["Re"])


@pytest.fixture(scope="module")
def problems(img):
    """{geometry: (JAX problem, port problem)}: (mesh, W, mask, g, kernel)
    of each package, built from the same parameters."""
    from stabilized_navier_stokes_flow_fenicsx_tpu.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu.fem.bc import (
        DirichletBC, bc_mask, bc_vector, combine_bcs)
    from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu.flow.channel import (
        channel_bcs, generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (
        make_ns_sups_kernel)

    inlet1, inlet2 = solve_inlet_profiles(img, CHANNEL["ratio"], DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, CHANNEL["lc"], DEFAULT,
                                       layered=True)
    W = make_mixed_space(mesh, 1, 1)
    _n2d, _Lp, used = mesh.layered
    unused = np.nonzero(~used)[0].astype(np.int64)
    unused_dofs = (unused[:, None] * 4 + np.arange(4)[None, :]).ravel()
    bc = combine_bcs([DirichletBC(unused_dofs, np.zeros(len(unused_dofs))),
                      channel_bcs(mesh, W, inlet1, inlet2)])
    jax_channel = (mesh, W, bc_mask(W.ndofs, bc).astype(np.float64),
                   bc_vector(W.ndofs, bc),
                   make_ns_sups_kernel("tetrahedron",
                                       nu=1.0 / CHANNEL["Re"]))
    return dict(
        duct=(jax_cases._duct_layered(), duct_problem()),
        channel=(jax_channel,
                 channel_problem(img, CHANNEL["lc"], CHANNEL["Re"])))
