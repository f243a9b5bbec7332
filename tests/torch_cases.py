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


def recording(module, name, calls):
    """Swap ``module.name`` for a wrapper that appends each result to
    ``calls``; returns the original."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out

    setattr(module, name, wrapper)
    return fn


def split_exact(w, w_lo):
    """w (f32) is w + w_lo rounded to f32, and w_lo is the remainder."""
    w64 = w.astype(np.float64) + w_lo
    assert w.dtype == np.float32 and w_lo.dtype == np.float64
    assert np.array_equal(w64.astype(np.float32), w)
    assert np.array_equal(w64 - w.astype(np.float64), w_lo)
    return w64


def compare_panels(sim_path, exp_path):
    """The three panels of ``compare_images`` (simulated, overlay, abs
    diff), computed with the JAX package's ``remove_gray_background`` and
    ``autocrop`` and PIL's resize, as compareImages.py computes them."""
    from PIL import Image

    from stabilized_navier_stokes_flow_fenicsx_tpu.apps import (
        compare_images as jax_compare_images)

    sim = np.asarray(Image.open(sim_path).convert("RGB"))
    exp = jax_compare_images.remove_gray_background(
        np.asarray(Image.open(exp_path).convert("RGB")))
    sim_c, exp_c = (jax_compare_images.autocrop(a) for a in (sim, exp))
    size = (max(sim_c.shape[1], exp_c.shape[1]),
            max(sim_c.shape[0], exp_c.shape[0]))
    sim_r, exp_r = (np.asarray(Image.fromarray(a).resize(size)).astype(int)
                    for a in (sim_c, exp_c))
    return size, [sim_r.astype(np.uint8),
                  (0.5 * sim_r + 0.5 * exp_r).astype(np.uint8),
                  np.abs(sim_r - exp_r).astype(np.uint8)]


def figure_panels(png, size, boxes):
    """The panels cut from a ``compare_images`` figure at ``boxes``."""
    from PIL import Image

    fig = Image.open(png).convert("RGB")
    return [np.asarray(fig.crop(box)) for box in boxes]
