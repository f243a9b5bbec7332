"""K4's host side on the CPU (no card, no JAX): the dispatch, the tables
and codes baked into its source, its refusals and the benchmark's reader
of its time.

* The structured route with CPU tensors takes the plain twin
  (forms/soa.py's ``jac_soa`` / ``res_soa`` in the chunk loops) for every
  flux, bit for bit as the route computed before K4 (the reference
  functions below are that route, kept here), never builds the kernel
  and counts no ``k4_launch``.
* The quadrature tables in ``csrc/soa_element.cu`` are
  ``_p1_tables("tetrahedron", 2)`` exactly, and its flux codes are
  forms/soa.py's, which the element kernels' SoA pairs carry.
* ``soa_element`` is one of ``utils/nvcc.py::KERNELS``.
* The wrapper refuses a CPU tensor and a pair it does not evaluate,
  before it builds anything, and takes the parameters as numbers.
* ``portbench/metrics/k4_ms.py`` sums the K4 kernels of a profile and
  reads None without them.

The mesh is a 4 x 4 cross-section extruded through 9 planes (the
structured plan of the channel, built in milliseconds; the plan pads it
to one chunk of columns, so most of its cells are padding).
"""

import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
    soa_element, structured)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
    build_layered, matrix_values_layered, residual_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms import soa
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
    make_ns_sups_kernel, make_ns_ugn_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes import (
    make_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.extrude import (
    extrude_tri_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (
    rect_tri)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import nvcc
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (
    counts)

import torch_kernel_bounds as kernel_bounds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "stabilized_navier_stokes_flow_fenicsx_tpu_torch",
                      "csrc", "soa_element.cu")
FLUXES = ("sups_t", "sups", "ugn")


def _kernel(flux: str, nu=0.05):
    if flux == "ugn":
        return make_ns_ugn_kernel("tetrahedron", nu)
    return make_ns_sups_kernel("tetrahedron", nu,
                               transposed_stab=flux == "sups_t")


@pytest.fixture(scope="module")
def box():
    mesh = extrude_tri_mesh(rect_tri(4, 4, (-0.5, -0.5), (0.5, 0.5)),
                            np.linspace(0.0, 4.0, 9))
    W = make_mixed_space(mesh, 1, 1)
    n2d, Lp, _ = mesh.layered
    lp = build_layered(W, n2d, Lp, torch.float64, "cpu")
    w = torch.as_tensor(
        np.random.default_rng(4).normal(size=W.ndofs) * 0.3)
    return lp, w


def _route_before_k4_values(kernel, E, Lp, bs, sasm, w):
    """matrix_values_structured_soa as it was before K4."""
    nl = Lp - 1
    ndl = sasm.wdof.shape[1]
    e2 = ndl * ndl
    M3p = sasm.coordsT.shape[1] // nl
    wT = structured.gather_wT(sasm, Lp, w)
    alive = sasm.alive.to(w.dtype)
    buf = w.new_empty((M3p * e2, nl))
    for k, c0, m in structured._chunks(M3p, nl, sasm.chunk_cells):
        sl = slice(c0, c0 + m * nl)
        J = kernel.jac_soa(sasm.coordsT[:, sl], wT[:, sl]) * alive[sl]
        buf[k * m * e2:(k + 1) * m * e2] = \
            J.reshape(e2, m, nl).permute(1, 0, 2).reshape(m * e2, nl)
    return structured._reduce_jac_buffer(buf, sasm, E, Lp, bs, ndl, nl,
                                         w.dtype)


def _route_before_k4_residual(kernel, Lp, sasm, w):
    """residual_structured as it was before K4."""
    nl = Lp - 1
    M3p, ndl = sasm.wdof.shape
    wT = structured.gather_wT(sasm, Lp, w)
    alive = sasm.alive.to(w.dtype)
    rbufz = w.new_zeros((M3p * ndl + 1, nl))
    for k, c0, m in structured._chunks(M3p, nl, sasm.chunk_cells):
        sl = slice(c0, c0 + m * nl)
        r = kernel.res_soa(sasm.coordsT[:, sl], wT[:, sl]) * alive[sl]
        rbufz[k * m * ndl:(k + 1) * m * ndl] = \
            r.reshape(ndl, m, nl).permute(1, 0, 2).reshape(m * ndl, nl)

    def reduce(tab, off):
        return structured._plane_shift_sum(rbufz[tab],
                                           off[:, :, None].to(w.dtype))

    R2 = reduce(sasm.rtab, sasm.roff)
    if sasm.rtab_over.shape[0] > 0:
        R2.index_add_(0, sasm.rover_ids,
                      reduce(sasm.rtab_over, sasm.roff_over))
    return R2.T.reshape(-1)


@pytest.mark.parametrize("entry", ["jacobian", "residual"])
@pytest.mark.parametrize("flux", FLUXES)
def test_cpu_takes_the_twin_bit_for_bit(box, flux, entry, monkeypatch):
    lp, w = box
    a, sasm = lp.arrays, lp.arrays.sasm

    def no_build(*args, **kw):
        raise AssertionError("K4 was built for a CPU tensor")

    monkeypatch.setattr(soa_element, "build", no_build)
    monkeypatch.setattr(nvcc, "kernel", no_build)
    kern = _kernel(flux)
    shapes = counts("k4_launch")
    if entry == "jacobian":
        got = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, a, w)
        ref = _route_before_k4_values(kern, lp.E, lp.n_planes, lp.bs, sasm,
                                      w)
    else:
        got = residual_layered(kern, lp.n2d, lp.n_planes, lp.bs, a, w)
        ref = _route_before_k4_residual(kern, lp.n_planes, sasm, w)
    assert torch.equal(got, ref) and bool(ref.abs().max() > 0)
    assert counts("k4_launch", shapes) == {}


def _constant(name: str) -> np.ndarray:
    src = open(SOURCE).read()
    m = re.search(r"__constant__ double " + name + r"\[[^=]*= \{(.*?)\};",
                  src, re.S)
    assert m, name
    return np.array([float(x) for x in re.findall(
        r"-?\d+\.\d+(?:e-?\d+)?", m.group(1))])


def test_the_source_tables_are_the_p1_rule():
    phi, dphi, wq = soa._p1_tables("tetrahedron", soa_element.QDEG)
    assert phi.shape == (kernel_bounds.K4_NQ, 4)
    np.testing.assert_array_equal(_constant("K4_PHI"), phi.ravel())
    np.testing.assert_array_equal(_constant("K4_DPHI"), dphi.ravel())
    np.testing.assert_array_equal(_constant("K4_WQ"), wq)


def test_the_flux_codes_are_the_source_codes():
    src = open(SOURCE).read()
    code = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (FLUX_\w+) = (\d+);", src)}
    assert code == {"FLUX_SUPS_T": soa.FLUX_SUPS_T,
                    "FLUX_SUPS": soa.FLUX_SUPS, "FLUX_UGN": soa.FLUX_UGN}
    assert _kernel("sups_t").soa.flux == soa.FLUX_SUPS_T
    assert _kernel("sups").soa.flux == soa.FLUX_SUPS
    assert _kernel("ugn").soa.flux == soa.FLUX_UGN
    for flux in FLUXES:
        pair = _kernel(flux).soa
        res_soa, jac_soa = pair                     # still a pair
        assert pair.qdeg == 2 and callable(res_soa) and callable(jac_soa)


def test_k4_is_built_with_the_other_kernels():
    assert "soa_element" in nvcc.KERNELS
    assert os.path.exists(SOURCE)


def test_kernel_args_take_numbers():
    assert soa_element.kernel_args(_kernel("sups_t", 0.1)) == (
        soa.FLUX_SUPS_T, 0.1, 36.0, 0.0)
    assert soa_element.kernel_args(_kernel("sups", torch.tensor(0.25))) == (
        soa.FLUX_SUPS, 0.25, 36.0, 0.0)
    assert soa_element.kernel_args(_kernel("ugn", 0.02)) == (
        soa.FLUX_UGN, 0.02, 0.0, soa.UGN_U_EPS)


@pytest.mark.parametrize("what", ["no_pair", "other_degree"])
def test_k4_refuses_a_pair_it_does_not_evaluate(box, what):
    lp, w = box
    if what == "no_pair":
        kern = make_stokes_kernel("tetrahedron", nu=1.0)
    else:
        kern = make_ns_sups_kernel("tetrahedron", 0.1, qdeg=3)
    with pytest.raises(ValueError, match="quadrature degree"):
        soa_element.jacobian(kern, lp.arrays.sasm, lp.n_planes, w)


@pytest.mark.parametrize("entry", ["jacobian", "residual"])
def test_k4_refuses_a_cpu_tensor(box, entry, monkeypatch):
    lp, w = box

    def no_build(*args, **kw):
        raise AssertionError("built before the check")

    monkeypatch.setattr(soa_element, "build", no_build)
    with pytest.raises(ValueError, match="runs on a CUDA card"):
        getattr(soa_element, entry)(_kernel("sups_t"), lp.arrays.sasm,
                                    lp.n_planes, w)


def test_the_bound_counts_every_entry_once(box):
    lp, w = box
    sasm = lp.arrays.sasm
    M3p, nl = sasm.wdof.shape[0], lp.n_planes - 1
    b = kernel_bounds.k4_bound("jacobian", "sups_t", sasm, lp.n_planes, w,
                               live_cells=M3p * nl)
    assert b["bytes"] > M3p * nl * 256 * 8
    assert b["flops"] == kernel_bounds.k4_flops_per_cell(
        "sups_t", "jacobian") * M3p * nl
    assert b["ms"] == max(b["bytes_ms"], b["flops_ms"])
    r = kernel_bounds.k4_bound("residual", "sups_t", sasm, lp.n_planes, w,
                               live_cells=M3p * nl)
    assert 16 * r["flops"] < 2 * b["flops"]
    assert r["bytes"] < b["bytes"] / 8


def _k4_ms():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import run as bench_run

    return bench_run.load_metric("k4_ms")


def test_k4_ms_reads_the_kernel_time():
    read = _k4_ms().read
    run = types.SimpleNamespace(profile=None, records=[])
    assert read(run) is None
    run.profile = types.SimpleNamespace(kernel_s={
        "void (anonymous namespace)::layered_spmv_kernel<double, double, 1>"
        "(...)": 0.046,
        "void (anonymous namespace)::streamtrace_kernel<double>(...)":
            0.003})
    assert read(run) is None
    run.profile.kernel_s.update({
        "void (anonymous namespace)::soa_jacobian_kernel<0, double>(...)":
            0.0125,
        "void (anonymous namespace)::soa_residual_kernel<0, double>(...)":
            0.0025})
    assert read(run) == pytest.approx(15.0, rel=1e-12)
