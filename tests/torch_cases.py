"""Shared CHANNEL-size cases for the PyTorch port's tests.

The JAX package builds the reference problem (tests/conftest.py runs it
on the CPU in float64); ``port_state`` hands the same operator, plan, BCs
and multigrid hierarchy to the port through ``convert.py`` as numpy
copies, so both implementations see identical inputs.
"""

import numpy as np
import torch

from stabilized_navier_stokes_flow_fenicsx_tpu.config import DEFAULT
from stabilized_navier_stokes_flow_fenicsx_tpu.flow.channel import (
    _setup_layered, generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu.flow.inlet import (
    solve_inlet_profiles)
from stabilized_navier_stokes_flow_fenicsx_tpu.utils.testimg import (
    make_annulus_image)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch import convert

from parity_fixtures import CHANNEL

# one intra-op thread per test process: the suite runs several worker
# processes side by side with JAX, and torch's default of one thread per
# core oversubscribes the CPU (tens of times slower at these small sizes)
torch.set_num_threads(1)


def channel_image(directory) -> str:
    """The CHANNEL image (tests/parity_fixtures.py): a 512 px circle."""
    return make_annulus_image(str(directory / "circle.png"),
                              CHANNEL["shape"])


def numpy_fields(nt) -> dict:
    """A JAX NamedTuple of arrays -> {name: numpy array}, recursively,
    dropping None fields."""
    return {k: numpy_fields(v) if hasattr(v, "_asdict") else np.asarray(v)
            for k, v in nt._asdict().items() if v is not None}


def jax_channel(img, lc=CHANNEL["lc"], mg_levels=3):
    """The JAX package's layered CHANNEL setup: (mesh, W, lp, mask, g,
    hierarchy or None)."""
    inlet1, inlet2 = solve_inlet_profiles(img, CHANNEL["ratio"], DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, lc, DEFAULT, layered=True)
    W, lp, mask, g, _g64, *hier = _setup_layered(
        mesh, inlet1, inlet2, mg_levels=mg_levels)
    return mesh, W, lp, mask, g, (hier[0] if hier else None)


def port_state(lp, mask, g, hier, device="cpu"):
    """The port's (arrays, mask, g, hierarchy) for the JAX setup."""
    arrays = convert.layered_arrays(numpy_fields(lp.arrays), device)
    hierarchy = None if hier is None else convert.mg_hierarchy(
        [numpy_fields(lv) for lv in hier.levels], hier.dims, device)
    return (arrays, convert.dof_vector(mask, device),
            convert.dof_vector(g, device), hierarchy)


def rel_l2(a, b) -> float:
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))

