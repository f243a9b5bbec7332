"""K1, the layered SpMV: the port's plain version against the JAX package
(the kernel against the plain version on the card is in
test_torch_layered_spmv_card.py, which imports no JAX).

Tolerances (relative L2):
* f64 values: 1e-12 — only the summation order differs;
* bf16 values, f32 x: 5e-3 — products are rounded to bf16 (JAX and the
  plain version) or taken in f32 from bf16 inputs (the kernel);
* f32 against the Pallas kernel in interpret mode: 1e-6 (f32 sums in
  another order).
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble.layered import (  # noqa: E402
    build_layered, layered_matvec, matrix_values_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu.assemble.pallas_spmv import (  # noqa: E402
    build_ell, ell_values, layered_matvec_pallas)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (  # noqa: E402
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (  # noqa: E402
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh.extrude import (  # noqa: E402
    extrude_channel)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh.image import (  # noqa: E402
    get_contours, load_image, optimize_contour)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh.tri2d import (  # noqa: E402
    triangulate_cross_section)
from stabilized_navier_stokes_flow_fenicsx_tpu.utils.testimg import (  # noqa: E402
    make_annulus_image)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch import convert  # noqa: E402
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (  # noqa: E402
    layered_spmv)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (  # noqa: E402
    layered_matvec as port_matvec)

from torch_cases import numpy_fields, rel_l2  # noqa: E402


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The lc=0.12 layered problem of tests/test_pallas_spmv.py."""
    img = str(tmp_path_factory.mktemp("k1") / "c.png")
    make_annulus_image(img, "circle", size=300)
    g = load_image(img)
    cs = get_contours(g)
    co, _ = optimize_contour(cs[0], cutoff=0.15, mesh_lc_frac=0.01)
    ci, _ = optimize_contour(cs[1], cutoff=0.15, mesh_lc_frac=0.01)
    inner = ci[:, [1, 0]]
    tri = triangulate_cross_section(inner, co[:, [1, 0]], lc=0.12)
    mesh = extrude_channel(tri, inner, lc=0.12, compact=False)
    n2d, n_planes, _ = mesh.layered
    W = make_mixed_space(mesh, 1, 1)
    lp = build_layered(W, n2d, n_planes)
    kern = make_ns_sups_kernel("tetrahedron", nu=0.1)
    rng = np.random.default_rng(3)
    w = jnp.asarray(rng.normal(size=W.ndofs) * 0.1)
    x = rng.normal(size=W.ndofs)
    vals = np.asarray(matrix_values_layered(kern, lp.E, n_planes, lp.bs,
                                            lp.arrays, w))
    arrays = convert.layered_arrays(numpy_fields(lp.arrays), "cpu")
    return lp, n2d, n_planes, vals, x, arrays


def test_plain_matches_jax_f64(problem):
    lp, n2d, n_planes, vals, x, arrays = problem
    y_ref = layered_matvec(lp.arrays, n2d, n_planes, jnp.asarray(vals),
                           jnp.asarray(x))
    y = port_matvec(arrays, n2d, n_planes, torch.as_tensor(vals),
                    torch.as_tensor(x))
    assert y.dtype == torch.float64
    assert rel_l2(y, y_ref) <= 1e-12


def test_plain_matches_jax_bf16_values(problem):
    lp, n2d, n_planes, vals, x, arrays = problem
    v_bf = jnp.asarray(vals).astype(jnp.bfloat16)
    x32 = x.astype(np.float32)
    y_ref = layered_matvec(lp.arrays, n2d, n_planes, v_bf, jnp.asarray(x32))
    # the same bf16 numbers on both sides (f32 holds them exactly)
    v_t = torch.as_tensor(np.asarray(v_bf.astype(jnp.float32))) \
        .to(torch.bfloat16)
    y = port_matvec(arrays, n2d, n_planes, v_t, torch.as_tensor(x32))
    assert y.dtype == torch.float32
    assert rel_l2(y, y_ref) <= 5e-3


def test_plain_matches_pallas_interpret_f32(problem):
    lp, n2d, n_planes, vals, x, arrays = problem
    ell = build_ell(lp.arrays, n2d, n_planes)
    y_ref = layered_matvec_pallas(ell, ell_values(ell, jnp.asarray(vals)),
                                  jnp.asarray(x), lp.bs, interpret=True)
    y = port_matvec(arrays, n2d, n_planes,
                    torch.as_tensor(vals.astype(np.float32)),
                    torch.as_tensor(x.astype(np.float32)))
    assert rel_l2(y, y_ref) <= 1e-6


def test_cpu_tensor_takes_plain_version(problem):
    """On the CPU the wrapper runs the plain version and launches
    nothing; the kernel entry point refuses CPU tensors."""
    _, n2d, n_planes, vals, x, arrays = problem
    before = layered_spmv.LAUNCHES
    y = layered_spmv.layered_spmv(
        torch.as_tensor(vals), torch.as_tensor(x), arrays.cols,
        arrays.row_ids, arrays.row_ptr, n2d)
    y_plain = layered_spmv.layered_matvec_plain(
        torch.as_tensor(vals), torch.as_tensor(x), arrays.cols,
        arrays.row_ids, n2d)
    assert torch.equal(y, y_plain)
    assert layered_spmv.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA device"):
        layered_spmv.layered_matvec_cuda(
            torch.as_tensor(vals), torch.as_tensor(x), arrays.cols,
            arrays.row_ptr, n2d)
