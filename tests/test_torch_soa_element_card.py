"""K4 on the card: the SoA element Jacobian and residual kernel against
its plain twin.

This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_soa_element_card.py

(``--noconftest``: tests/conftest.py configures JAX).  Without a card
every test skips.  ``soa_element.jacobian`` / ``residual``
(csrc/soa_element.cu) and the twin (``structured._jac_buffer_plain`` /
``_res_buffer_plain``: forms/soa.py's ``jac_soa`` / ``res_soa`` in the
chunk loops, run on the card too) fill the same layer-minor buffers from
the same plan and state:

* the CHANNEL mesh (lc=0.12, with the splitter's dead cells and the
  plan's padding columns) and a DFG 3D-1Z pillar (apps/dfg3d.py at scale
  2.0: a plane with a hole, Lp = 7; the pillar's own chunk);
* float64 and float32 (the plan built in that dtype, as the refine
  route's float32 Jacobian has it);
* the three fluxes: SUPS with ``transposed_stab`` (the channel's), SUPS
  without it (the pillar's) and UGN;
* a random nonzero state, so that every slot of the flux's state is live;
* dead cells and padding columns exactly zero;
* one ``k4_launch`` per call, under its key;
* the structured route on a CUDA tensor launches K4 (never the twin) and
  agrees with the route on CPU tensors;
* the wrapper's refusals: a CPU tensor, a wrong dtype, a non-contiguous
  ``w``, a parameter held on the card.

Tolerance: relative to the largest entry of the twin's buffer, 1e-12 in
float64 and 1e-5 in float32.  K4 takes each column's flux derivative
along its own tangent (the twin combines 16 unit-tangent derivatives)
and fuses multiply-adds, so each entry differs in its last bits: a few
units of the working precision (2.2e-16, 1.2e-7) times the terms of a
cell, which the Galerkin, SUPS and LSIC parts make up to ~10x an entry.
"""

import numpy as np
import pytest
import torch

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
    soa_element, structured)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
    build_layered, matrix_values_layered, residual_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
    generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
    make_ns_sups_kernel, make_ns_ugn_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (
    counts)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
    make_annulus_image)

from parity_fixtures import CHANNEL

DTYPES = {"float64": torch.float64, "float32": torch.float32}
TOLS = {torch.float64: 1e-12, torch.float32: 1e-5}
FLUXES = ("sups_t", "sups", "ugn")
ENTRIES = ("jacobian", "residual")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _kernel(flux: str, nu: float):
    if flux == "ugn":
        return make_ns_ugn_kernel("tetrahedron", nu)
    return make_ns_sups_kernel("tetrahedron", nu,
                               transposed_stab=flux == "sups_t")


def _mesh(name: str, tmp):
    if name == "channel":
        img = make_annulus_image(str(tmp / "circle.png"), CHANNEL["shape"])
        mesh, _, _ = generate_channel_mesh(img, CHANNEL["lc"], DEFAULT)
        return mesh, 1.0 / CHANNEL["Re"], {}
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps import dfg3d

    mesh = dfg3d.dfg3d_mesh(2.0)
    return mesh, dfg3d.NU, dict(
        chunk_cells=min(dfg3d.ASM_CHUNK_CELLS, mesh.n_cells))


@pytest.fixture(scope="module", params=["channel", "pillar"])
def problem(request, tmp_path_factory):
    """The mesh's layered patterns on the card, one per dtype, and a
    random state."""
    dev = _card()
    mesh, nu, kw = _mesh(request.param,
                         tmp_path_factory.mktemp(f"k4{request.param}"))
    W = make_mixed_space(mesh, 1, 1)
    n2d, Lp, _ = mesh.layered
    lps = {dt: build_layered(W, n2d, Lp, dt, dev, **kw)
           for dt in DTYPES.values()}
    w = np.random.default_rng(19).normal(size=W.ndofs) * 0.3
    return dict(name=request.param, mesh=mesh, W=W, n2d=n2d, Lp=Lp,
                lps=lps, nu=nu, w=w, kw=kw, dev=dev)


def _dead(sasm):
    """(M3p, nl) bool: dead cells and the padding columns."""
    M3p = sasm.wdof.shape[0]
    return (sasm.alive == 0).reshape(M3p, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("flux", FLUXES)
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_k4_matches_the_twin(problem, dname, flux, entry):
    dtype = DTYPES[dname]
    lp = problem["lps"][dtype]
    sasm, Lp = lp.arrays.sasm, lp.n_planes
    w = torch.as_tensor(problem["w"], dtype=dtype, device=problem["dev"])
    kern = _kernel(flux, problem["nu"])
    before = counts("k4_launch")
    buf = getattr(soa_element, entry)(kern, sasm, Lp, w)
    torch.cuda.synchronize()
    M3p = sasm.wdof.shape[0]
    assert sum(counts("k4_launch", before).values()) == 1
    assert counts("k4_launch", before) == {
        (M3p * (Lp - 1), Lp - 1, dname, flux, entry): 1}
    twin = (structured._jac_buffer_plain if entry == "jacobian"
            else structured._res_buffer_plain)(kern, Lp, sasm, w)
    assert sum(counts("k4_launch", before).values()) == 1
    assert buf.shape == twin.shape and buf.dtype == dtype
    assert torch.isfinite(buf).all()
    scale = float(twin.abs().max())
    err = float((buf - twin).abs().max())
    print(f"\n{problem['name']} {dname} {flux} {entry}: max |twin| "
          f"{scale:.3e}, max |K4 - twin| {err:.3e} ({err / scale:.2e})")
    assert scale > 0 and err <= TOLS[dtype] * scale
    dead = _dead(sasm)
    if problem["name"] == "channel":     # the splitter, the padding
        assert bool(dead.any())
    rows = 256 if entry == "jacobian" else 16
    cells = buf[:M3p * rows].reshape(M3p, rows, Lp - 1)
    assert bool((cells.permute(0, 2, 1)[dead] == 0).all())
    assert bool((twin[:M3p * rows].reshape(M3p, rows, Lp - 1)
                 .permute(0, 2, 1)[dead] == 0).all())
    if entry == "residual":      # the appended row the reduction reads
        assert bool((buf[M3p * 16] == 0).all())


@pytest.mark.cuda
def test_the_route_on_the_card_launches_k4(problem, monkeypatch):
    """matrix_values_layered and residual_layered on CUDA tensors: one
    K4 launch each, no twin, and the values of the route on CPU tensors
    (a plan built on the CPU) to the twin's tolerance."""
    lp = problem["lps"][torch.float64]
    kern = _kernel("sups_t" if problem["name"] == "channel" else "sups",
                   problem["nu"])
    lp_cpu = build_layered(problem["W"], problem["n2d"], problem["Lp"],
                           torch.float64, "cpu", **problem["kw"])
    w_cpu = torch.as_tensor(problem["w"], dtype=torch.float64)
    V_cpu = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs,
                                  lp_cpu.arrays, w_cpu)
    R_cpu = residual_layered(kern, lp.n2d, lp.n_planes, lp.bs,
                             lp_cpu.arrays, w_cpu)

    def twin(*a, **k):
        raise AssertionError("the twin ran on a CUDA tensor")

    monkeypatch.setattr(structured, "_jac_buffer_plain", twin)
    monkeypatch.setattr(structured, "_res_buffer_plain", twin)
    w = w_cpu.to(problem["dev"])
    before = counts("k4_launch")
    V = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, lp.arrays, w)
    R = residual_layered(kern, lp.n2d, lp.n_planes, lp.bs, lp.arrays, w)
    torch.cuda.synchronize()
    assert sum(counts("k4_launch", before).values()) == 2
    for got, ref in ((V, V_cpu), (R, R_cpu)):
        scale = float(ref.abs().max())
        assert float((got.cpu() - ref).abs().max()) <= 1e-12 * scale


def _refuses(problem, w, match, kern=None):
    lp = problem["lps"][torch.float64]
    kern = kern or _kernel("sups_t", problem["nu"])
    for entry in ENTRIES:
        with pytest.raises(ValueError, match=match):
            getattr(soa_element, entry)(kern, lp.arrays.sasm, lp.n_planes,
                                        w)


@pytest.mark.cuda
@pytest.mark.parametrize("fault, match", [
    ("cpu", "runs on a CUDA card"), ("float16", "float64 or float32"),
    ("strided", "not contiguous"), ("nu_on_card", "parameters as numbers")])
def test_k4_refuses(problem, fault, match):
    w = torch.as_tensor(problem["w"], device=problem["dev"])
    kern = None
    if fault == "cpu":
        w = w.cpu()
    elif fault == "float16":
        w = w.half()
    elif fault == "strided":
        w = torch.stack([w, w], dim=1)[:, 0]
        assert not w.is_contiguous()
    else:
        kern = make_ns_sups_kernel(
            "tetrahedron", torch.tensor(problem["nu"], device=problem["dev"]))
    before = counts("k4_launch")
    _refuses(problem, w, match, kern)
    assert counts("k4_launch", before) == {}
