"""The port's Chebyshev V-cycle against the JAX package's ``make_mg_pc``.

CHANNEL mesh, the Navier-Stokes Jacobian at the stored CHANNEL solution
(tests/fixtures/channel_ns.npz, Re=10), one V-cycle apply on a seeded r.
Tolerances (relative L2): 1e-5 with f64 level values, since the smoother
runs in f32 on both sides (the port also keeps the smoother's mask and
matvec in f32, where the JAX package takes them in the mask's f64); 2e-2
with bf16 level values; 1e-5 for the ``_lam_max_tail`` spectral
estimates.
"""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble.layered import (  # noqa: E402
    matrix_values_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.solve import mg as jax_mg  # noqa: E402
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    driver, mg)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import (channel_image, jax_channel, port_state,  # noqa: E402
                         rel_l2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    img = channel_image(tmp_path_factory.mktemp("mg"))
    mesh, W, lp, mask, g, hier = jax_channel(img)
    w = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / CHANNEL["Re"])
    vals = np.asarray(matrix_values_layered(
        kern, lp.E, lp.n_planes, lp.bs, lp.arrays, jnp.asarray(w)))
    r = np.random.default_rng(11).standard_normal(W.ndofs)
    return lp, mask, g, hier, vals, r


def _build(case, pc_dtype):
    lp, mask, g, hier, vals, r = case
    a = lp.arrays
    apply_j = jax_mg.make_mg_pc(
        hier, jnp.asarray(vals), a.cols, a.row_ids, a.diag_pos, mask,
        lp.n2d, lp.n_planes, pc_dtype=pc_dtype and jnp.bfloat16,
        smoother="cheby")
    arrays, mask_t, _, hier_t = port_state(lp, mask, g, hier)
    apply_t = mg.make_mg_pc(
        hier_t, torch.as_tensor(vals), arrays.cols, arrays.row_ids,
        arrays.row_ptr, arrays.diag_pos, mask_t, lp.n2d, lp.n_planes,
        pc_dtype=pc_dtype and torch.bfloat16)
    return apply_j, apply_t


@pytest.mark.parametrize("pc_dtype, tol", [(None, 1e-5), ("bf16", 2e-2)])
def test_vcycle_apply_matches_jax(case, pc_dtype, tol):
    r = case[-1]
    apply_j, apply_t = _build(case, pc_dtype)
    x_ref = apply_j(jnp.asarray(r))
    x = apply_t(torch.as_tensor(r))
    assert x.dtype == torch.float64 and torch.isfinite(x).all()
    assert rel_l2(x, x_ref) <= tol


def test_lam_max_tail_matches_jax(case, monkeypatch):
    """The per-level spectral estimates, recorded as each make_mg_pc
    computes them (the JAX package's estimate is the result of its
    12-step power iteration loop)."""
    seen_j, seen_t = [], []
    fori = jax.lax.fori_loop

    def recording_fori(lo, hi, body, init):
        out = fori(lo, hi, body, init)
        if hi == 12:
            seen_j.append(float(out[1]))
        return out

    lam_t = mg._lam_max_tail

    def recording_lam(*args, **kw):
        out = lam_t(*args, **kw)
        seen_t.append(float(out))
        return out

    monkeypatch.setattr(jax.lax, "fori_loop", recording_fori)
    monkeypatch.setattr(mg, "_lam_max_tail", recording_lam)
    _build(case, None)
    n_levels = len(case[3].levels) + 1
    assert len(seen_j) == len(seen_t) == n_levels
    assert rel_l2(seen_t, seen_j) <= 1e-5


@pytest.mark.parametrize("pc", ["mg", "mg_jacobi", "mg_chebyw_bf16",
                                "plane_gs"])
def test_other_smoothers_are_refused(case, pc):
    lp, mask, g, hier, vals, _ = case
    arrays, mask_t, _, hier_t = port_state(lp, mask, g, hier)
    with pytest.raises(NotImplementedError):
        driver._layered_pc(pc, arrays, lp.n2d, lp.n_planes, mask_t, hier_t)


@pytest.mark.parametrize("pc, parsed", [
    ("mg_cheby_bf16", (6, torch.bfloat16)),
    ("mg_cheby4_bf16", (4, torch.bfloat16)),
    ("mg_cheby", (6, None)),
    ("mg_cheby_bf32", None),
    ("jacobi", None),
])
def test_parse_mg_pc(pc, parsed):
    assert driver.parse_mg_pc(pc) == parsed


def test_coarsest_level_above_dense_cap_is_refused(case, monkeypatch):
    lp, mask, g, hier, vals, _ = case
    arrays, mask_t, _, hier_t = port_state(lp, mask, g, hier)
    n2d_c, Lp_c, _ = hier_t.dims[-1]
    monkeypatch.setattr(mg, "DENSE_CAP", n2d_c * Lp_c * lp.bs - 1)
    with pytest.raises(ValueError, match="dense coarse solve"):
        mg.make_mg_pc(hier_t, torch.as_tensor(vals), arrays.cols,
                      arrays.row_ids, arrays.row_ptr, arrays.diag_pos,
                      mask_t, lp.n2d, lp.n_planes)
