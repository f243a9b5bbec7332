"""K1's prepared operand (assemble/layered_spmv.py::LayeredOperand) on the
CPU, where it runs its plain version on the kernel layout, against the
JAX package on every V-cycle level of the CHANNEL problem (lc=0.12).

The values are the port's Galerkin levels (solve/mg.py::galerkin_levels)
of the Navier-Stokes Jacobian at the stored CHANNEL solution, on the JAX
package's hierarchy; the same numbers go to JAX's ``layered_matvec``
(unmasked) and ``make_layered_op`` (masked).  Tolerances (relative L2):

* f64 values, f64 x: 1e-12 — the same products, summed in another order;
* bf16 values, f32 or f64 x: 5e-3 — both sides round x to bf16 and each
  product to bf16 and sum in x's dtype, but JAX and PyTorch round bf16
  products of a sum in other orders; 5e-3 is about two bf16 ulps of the
  sum.

Also: the layout's padding planes are zero, the launch shape the wrapper
picks, the refusals at build and call time, and ``default_device``
raising without a card.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import (  # noqa: E402
    layered as jax_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu.assemble.layered import (  # noqa: E402
    matrix_values_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.solve.mg import (  # noqa: E402
    _project_values, _stub_arrays)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch import config  # noqa: E402
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (  # noqa: E402
    layered_spmv)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered_spmv import (  # noqa: E402
    LayeredOperand, kernel_layout, launch_shape, layered_matvec_plain,
    padded_planes)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (  # noqa: E402
    solve_ns_flow)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.mg import (  # noqa: E402
    galerkin_levels)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.trace.pipeline import (  # noqa: E402
    for_and_rev_streamtrace)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (  # noqa: E402
    counts)

from parity_fixtures import CHANNEL, FIXTURE_DIR  # noqa: E402
from torch_cases import (channel_image, jax_channel, port_state,  # noqa: E402
                         rel_l2)

PAIRS = [(torch.float64, torch.float64, 1e-12),
         (torch.bfloat16, torch.float32, 5e-3),
         (torch.bfloat16, torch.float64, 5e-3)]


@pytest.fixture(scope="module")
def levels(tmp_path_factory):
    """Every V-cycle level (values, pair list, mask) on the CPU in f64."""
    img = channel_image(tmp_path_factory.mktemp("k1op"))
    _, _, lp, mask, g, hier = jax_channel(img)
    w = np.load(FIXTURE_DIR / "channel_ns.npz")["w"]
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / CHANNEL["Re"])
    vals = np.asarray(matrix_values_layered(
        kern, lp.E, lp.n_planes, lp.bs, lp.arrays, jnp.asarray(w)))
    arrays, mask_t, _, hier_t = port_state(lp, mask, g, hier)
    return galerkin_levels(hier_t, torch.as_tensor(vals), arrays.cols,
                           arrays.row_ids, arrays.row_ptr, arrays.diag_pos,
                           mask_t, lp.n2d, lp.n_planes)


def _jax_reference(op, v, x, masked):
    """JAX's layered_matvec / make_layered_op on the same numbers (bf16
    values pass through f32, which holds them exactly)."""
    arrays = _stub_arrays(jnp.asarray(op.cols.numpy()),
                          jnp.asarray(op.row_ids.numpy()))
    vj = jnp.asarray(v.to(torch.float32).numpy() if v.dtype == torch.bfloat16
                     else v.numpy())
    if v.dtype == torch.bfloat16:
        vj = vj.astype(jnp.bfloat16)
    xj = jnp.asarray(x.numpy())
    if masked:
        mj = jnp.asarray(op.mask.to(x.dtype).numpy())
        return jax_layered.make_layered_op(arrays, op.n2d, op.n_planes, vj,
                                           mj)(xj)
    return jax_layered.layered_matvec(arrays, op.n2d, op.n_planes, vj, xj)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("vdtype, xdtype, tol", PAIRS)
def test_operand_matches_jax_on_every_level(levels, vdtype, xdtype, tol,
                                            masked):
    assert len(levels) >= 2        # the fine level and at least one RAP
    rng = np.random.default_rng(7)
    before = counts("k1_launch")
    for k, op in enumerate(levels):
        K = LayeredOperand(op.values, op.cols, op.row_ptr, op.n2d,
                           mask=op.mask if masked else None, dtype=vdtype)
        x = torch.as_tensor(rng.standard_normal(op.mask.numel())) \
            .to(xdtype)
        y = K(x)
        assert y.dtype == xdtype and torch.isfinite(y).all()
        y_ref = _jax_reference(op, op.values.to(vdtype), x, masked)
        assert rel_l2(y, y_ref) <= tol, f"level {k}"
    assert counts("k1_launch", before) == {}    # the CPU launches nothing


@pytest.mark.parametrize("vdtype", [torch.float64, torch.float32,
                                    torch.bfloat16])
def test_layout_pads_planes_with_zeros(levels, vdtype):
    """Every level's kernel layout: (E, 48, Lp_pad), row (c*4+j)*3+d
    holding V[c, j, d, e, :Lp], planes Lp.. zero, rows 16-byte whole."""
    for op in levels:
        K = LayeredOperand(op.values, op.cols, op.row_ptr, op.n2d,
                           dtype=vdtype)
        E, Lp = op.values.shape[3], op.n_planes
        assert K.Lp_pad == padded_planes(Lp, vdtype) >= Lp
        assert (K.Lp_pad * K.values.element_size()) % 16 == 0
        assert K.Lp_pad - Lp < 16 // K.values.element_size()
        assert K.values.shape == (E, 48, K.Lp_pad)
        assert K.values.dtype == vdtype and K.values.is_contiguous()
        assert not K.values[:, :, Lp:].any()
        want = op.values.to(vdtype).reshape(48, E, Lp).permute(1, 0, 2)
        assert torch.equal(K.values[:, :, :Lp], want)
        c, j, d, e = 2, 3, 0, E // 2
        assert torch.equal(K.values[e, (c * 4 + j) * 3 + d, :Lp],
                           op.values[c, j, d, e].to(vdtype))


F64, F32, BF16 = torch.float64, torch.float32, torch.bfloat16


@pytest.mark.parametrize("vdtype", [torch.float64, torch.bfloat16])
def test_masked_layout_is_the_projected_operator(levels, vdtype):
    """With a mask the layout holds P A P, as the JAX package's V-cycle
    projects it (solve/mg.py::_project_values), so the kernel reads no
    mask for x."""
    for op in levels:
        K = LayeredOperand(op.values, op.cols, op.row_ptr, op.n2d,
                           mask=op.mask, dtype=vdtype)
        want = np.asarray(_project_values(
            jnp.asarray(op.values.numpy()), jnp.asarray(op.mask.numpy()),
            jnp.asarray(op.cols.numpy()), jnp.asarray(op.row_ids.numpy()),
            op.n2d, op.n_planes))
        want = kernel_layout(torch.as_tensor(want), K.Lp_pad, vdtype)
        assert torch.equal(K.values, want)


@pytest.mark.parametrize("Lp_pad, vdtype, xdtype, shape", [
    (80, BF16, F32, (4, 1)),        # lc=0.04 level 0: an 80-thread team
    (80, BF16, F64, (4, 1)),
    (78, F64, F64, (1, 1)),         # the f64 outer operator: 312 threads
    (40, BF16, F32, (4, 1)),        # the coarse levels
    (16, BF16, F32, (4, 4)),        # 16-thread teams, 4 to a block
    (156, F64, F64, (2, 1)),        # 624 threads at 1 plane: 2
    (400, F64, F64, (4, 1)),        # 800 threads at 2 planes: 4
    (800, F32, F32, (8, 1)),        # 800 threads at 4 planes: 8
])
def test_launch_shape(Lp_pad, vdtype, xdtype, shape):
    ppt, teams = launch_shape(Lp_pad, vdtype, xdtype)
    assert (ppt, teams) == shape
    assert Lp_pad % ppt == 0
    team = 4 * Lp_pad // ppt
    assert team <= layered_spmv.MAX_TEAM
    assert team * teams <= max(layered_spmv.BLOCK_THREADS, team)


def test_launch_shape_refuses_too_many_planes():
    with pytest.raises(ValueError, match="team"):
        launch_shape(1200, F64, F64)


def _refusals(op):
    """(name, callable, error) for what the operand does not take."""
    v, cols, rp, n2d, m = op.values, op.cols, op.row_ptr, op.n2d, op.mask
    good = LayeredOperand(v, cols, rp, n2d, mask=m)
    x = torch.zeros(m.numel(), dtype=torch.float64)
    return {
        "values_f16": (lambda: LayeredOperand(v, cols, rp, n2d,
                                              dtype=torch.float16),
                       TypeError),
        "values_shape": (lambda: LayeredOperand(v[:, :, :2], cols, rp, n2d),
                         ValueError),
        "cols_int32": (lambda: LayeredOperand(v, cols.int(), rp, n2d),
                       TypeError),
        "row_ptr_length": (lambda: LayeredOperand(v, cols, rp[:-1], n2d),
                           ValueError),
        "mask_shape": (lambda: LayeredOperand(v, cols, rp, n2d, mask=m[:-4]),
                       ValueError),
        "mask_int": (lambda: LayeredOperand(v, cols, rp, n2d,
                                            mask=m.long()), ValueError),
        "cols_noncontiguous": (
            lambda: LayeredOperand(v, torch.stack([cols, cols], 1)[:, 0],
                                   rp, n2d), ValueError),
        "x_bf16": (lambda: good(x.to(torch.bfloat16)), ValueError),
        "x_int": (lambda: good(x.long()), ValueError),
        "x_shape": (lambda: good(x[:-4]), ValueError),
        "x_device": (lambda: good(x.to("meta")), ValueError),
    }


@pytest.mark.parametrize("case", [
    "values_f16", "values_shape", "cols_int32", "row_ptr_length",
    "mask_shape", "mask_int", "cols_noncontiguous", "x_bf16", "x_int",
    "x_shape", "x_device"])
def test_operand_refuses_what_it_does_not_take(levels, case):
    fn, err = _refusals(levels[0])[case]
    with pytest.raises(err):
        fn()


def test_plain_version_is_the_operand_call_on_the_cpu(levels):
    op = levels[1]
    K = LayeredOperand(op.values, op.cols, op.row_ptr, op.n2d, mask=op.mask,
                       dtype=torch.bfloat16)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        op.mask.numel()), dtype=torch.float32)
    assert torch.equal(K(x), layered_matvec_plain(K, x))
    # the mask rows are the identity
    free = K.masks[torch.float32] == 1
    assert torch.equal(K(x)[~free], x[~free])


@pytest.mark.parametrize("entry", ["default_device", "solve_ns_flow",
                                   "for_and_rev_streamtrace"])
def test_entry_points_refuse_to_run_without_a_card(monkeypatch, entry):
    """No quiet fallback to the CPU: without a card an entry point raises
    unless the caller passes device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "default_device": config.default_device,
        "solve_ns_flow": lambda: solve_ns_flow(10.0, "no-such.png", 0.5),
        "for_and_rev_streamtrace": lambda: for_and_rev_streamtrace(
            4, "no-such.png", None, np.zeros((3, 3)), np.zeros((1, 2))),
    }
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()
