"""K4: the structured route's SoA element Jacobian and residual on the card.

``jacobian`` and ``residual`` launch ``csrc/soa_element.cu`` once each over
the whole structured mesh, writing the layer-minor buffers that
``assemble/structured.py`` reduces: the Jacobian's ``buf`` (M3p*256, nl)
and the residual's ``rbufz`` (M3p*16 + 1, nl).  They read the plan's own
tables (``coordsT``, ``alive``, ``wdof``, ``wolay``) and ``w`` in place, so
the (16, M3p*nl) gather of ``structured.gather_wT`` is not built, and
``chunk_cells`` does not apply.  The flux comes from the kernel's SoA pair
(``forms/soa.py::SoaPair.flux``: SUPS with or without ``transposed_stab``,
or UGN), the parameters from ``kernel.params`` as numbers (no device read).
K4 replaces no TPU kernel: the JAX package's ``forms/soa.py`` is jnp code.

The twin is ``forms/soa.py``'s ``res_soa`` / ``jac_soa`` under the chunk
loops of ``assemble/structured.py``, which serve CPU tensors; on a CUDA
tensor the structured route launches K4 or raises.  The kernel is built
at first use with ``nvcc`` into ``build/torch_kernels/`` (utils/nvcc.py).
Each launch adds one to the tracer's counter ``k4_launch`` under (cells,
nl, dtype, flux, entry); ``LAUNCHES`` reads it.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Dict, Optional

import torch

from ..forms.soa import FLUX_SUPS, FLUX_SUPS_T, FLUX_UGN, UGN_U_EPS
from ..utils import nvcc
from ..utils.profiling import count, counts

if TYPE_CHECKING:
    from .structured import StructuredAsm

COUNTER = "k4_launch"
_reset_at: Dict = {}      # the counter at the last ``reset_launches``
_DTYPE = {torch.float64: 0, torch.float32: 1}
_ENTRY = {"jacobian": 0, "residual": 1}
FLUX_NAMES = {FLUX_SUPS_T: "sups_t", FLUX_SUPS: "sups", FLUX_UGN: "ugn"}
QDEG = 2                  # the quadrature rule baked into the source
NQ = 4
_LIB: Optional[ctypes.CDLL] = None

# Operations a cell costs K4 (a fused multiply-add counts 2), counted from
# csrc/soa_element.cu: the cell's set-up (geometry, basis gradients, the
# metric or the diameter, Gu and gp), then per quadrature point the values
# (32), the flux (primal, or in dual numbers along one tangent) and the
# E^T contraction into 16 accumulators (144), and the 16 scalings (32).
# The Jacobian's 16 threads a cell each do all of it.
_SETUP_FLOPS = {FLUX_SUPS_T: 275, FLUX_SUPS: 275, FLUX_UGN: 279}
_FLUX_FLOPS = {FLUX_SUPS_T: (112, 322), FLUX_SUPS: (97, 274),
               FLUX_UGN: (88, 241)}   # (primal, dual)
# H100 SXM vector rates without the tensor cores (NVIDIA's data sheet)
FLOPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = nvcc.kernel("soa_element")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.soa_element.restype = ci
        lib.soa_element.argtypes = [ci, ci, ci, vp, vp, vp, vp, vp, vp, ci,
                                    ci, ctypes.c_longlong, ctypes.c_double,
                                    ctypes.c_double, ctypes.c_double, vp]
        _LIB = lib
    return _LIB


def _number(p) -> float:
    """A kernel parameter as a Python float, without a device read."""
    if isinstance(p, torch.Tensor) and p.device.type != "cpu":
        raise ValueError(f"soa_element: K4 takes its parameters as numbers, "
                         f"got a tensor on {p.device}")
    return float(p)


def kernel_args(kernel):
    """(flux code, nu, C_I, u_eps) of an element kernel with an SoA pair;
    raises on a pair K4 does not evaluate."""
    soa = kernel.soa
    flux = getattr(soa, "flux", None)
    if flux not in FLUX_NAMES or getattr(soa, "qdeg", None) != QDEG:
        raise ValueError(f"soa_element: K4 evaluates the SUPS and UGN SoA "
                         f"pairs of forms/soa.py at quadrature degree "
                         f"{QDEG}; got flux {flux}, degree "
                         f"{getattr(soa, 'qdeg', None)}")
    params = [_number(p) for p in kernel.params]
    if flux == FLUX_UGN:
        (nu,) = params
        return flux, nu, 0.0, UGN_U_EPS
    nu, c_i = params
    return flux, nu, c_i, 0.0


def _check(sasm: StructuredAsm, Lp: int, w: torch.Tensor) -> None:
    """Raise unless w and the plan's tables are what K4 reads: one CUDA
    device, w contiguous float64 or float32 of Lp planes, the tables
    contiguous and shaped as the plan builds them."""
    if w.device.type != "cuda":
        raise ValueError(f"soa_element: K4 runs on a CUDA card; w is on "
                         f"{w.device}")
    if w.dtype not in _DTYPE:
        raise ValueError(f"soa_element: K4 takes float64 or float32 w, got "
                         f"{w.dtype}")
    if not w.is_contiguous():
        raise ValueError("soa_element: w is not contiguous")
    M3p, ndl = sasm.wdof.shape
    nl = Lp - 1
    if w.dim() != 1 or w.numel() % Lp or ndl != 16 \
            or tuple(sasm.coordsT.shape) != (12, M3p * nl) \
            or tuple(sasm.alive.shape) != (M3p * nl,) \
            or tuple(sasm.wolay.shape) != (M3p, ndl):
        raise ValueError(
            f"soa_element: K4 takes w (Lp * n2d * bs,), coordsT (12, M3p * "
            f"nl), alive (M3p * nl,), wdof and wolay (M3p, 16); got w "
            f"{tuple(w.shape)} with Lp {Lp}, coordsT "
            f"{tuple(sasm.coordsT.shape)}, alive {tuple(sasm.alive.shape)}, "
            f"wdof {tuple(sasm.wdof.shape)}, wolay "
            f"{tuple(sasm.wolay.shape)}")
    for name, want in (("coordsT", None), ("alive", torch.float32),
                       ("wdof", torch.int64), ("wolay", torch.int64)):
        t = getattr(sasm, name)
        if (want is not None and t.dtype != want) or t.device != w.device:
            raise ValueError(f"soa_element: {name} is {t.dtype} on "
                             f"{t.device}, K4 needs {want or 'a float'} on "
                             f"{w.device}")
        if not t.is_contiguous():
            raise ValueError(f"soa_element: {name} is not contiguous")


def _launch(entry: str, kernel, sasm: StructuredAsm, Lp: int,
            w: torch.Tensor) -> torch.Tensor:
    flux, nu, c_i, u_eps = kernel_args(kernel)
    _check(sasm, Lp, w)
    M3p = sasm.wdof.shape[0]
    nl = Lp - 1
    rows = M3p * 256 if entry == "jacobian" else M3p * 16 + 1
    out = w.new_empty((rows, nl))
    # the twin's coordsT.to(dtype): a no-op where the plan's coordinates
    # are in w's dtype, as every route builds them
    coordsT = sasm.coordsT.to(w.dtype)
    with torch.cuda.device(w.device):
        err = build().soa_element(
            _ENTRY[entry], _DTYPE[w.dtype], flux, coordsT.data_ptr(),
            sasm.alive.data_ptr(), sasm.wdof.data_ptr(),
            sasm.wolay.data_ptr(), w.data_ptr(), out.data_ptr(), M3p, nl,
            w.numel() // Lp, nu, c_i, u_eps,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"soa_element: K4 {entry} launch failed "
                           f"(cudaError {err})")
    count(COUNTER, key=(M3p * nl, nl, str(w.dtype).replace("torch.", ""),
                        FLUX_NAMES[flux], entry))
    return out


def jacobian(kernel, sasm: StructuredAsm, Lp: int,
             w: torch.Tensor) -> torch.Tensor:
    """(M3p*256, nl) layer-minor element Jacobians of every structured
    cell (``matrix_values_structured_soa``'s buffer), one launch, on w's
    stream, without a host read; dead and padding cells zero."""
    return _launch("jacobian", kernel, sasm, Lp, w)


def residual(kernel, sasm: StructuredAsm, Lp: int,
             w: torch.Tensor) -> torch.Tensor:
    """(M3p*16 + 1, nl) layer-minor element residuals with the appended
    zero row (``residual_structured``'s buffer), one launch."""
    return _launch("residual", kernel, sasm, Lp, w)


def flops_per_cell(flux: int, entry: str) -> int:
    """Operations K4 spends on one live cell (``_FLUX_FLOPS``)."""
    primal, dual = _FLUX_FLOPS[flux]
    per_thread = _SETUP_FLOPS[flux] + NQ * (
        32 + (dual if entry == "jacobian" else primal) + 144) + 32
    return per_thread * (16 if entry == "jacobian" else 1)


def bound_ms(entry: str, flux: int, sasm: StructuredAsm, Lp: int,
             w: torch.Tensor, live_cells: int) -> dict:
    """The least time the card could take for one launch: the bytes
    (the output written once, coordinates, alive, the gather tables and w
    read once) over 3.35 TB/s, and the operations of the live cells over
    the card's vector rate in w's dtype (34 TFLOP/s f64, 67 f32)."""
    M3p = sasm.wdof.shape[0]
    nl = Lp - 1
    item = w.element_size()
    out_rows = M3p * 256 if entry == "jacobian" else M3p * 16 + 1
    nbytes = (out_rows * nl * item + 12 * M3p * nl * item + 4 * M3p * nl
              + 2 * 16 * 8 * M3p + w.numel() * item)
    flops = flops_per_cell(flux, entry) * live_cells
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / FLOPS_PER_S[w.dtype] * 1e3
    return dict(bytes=nbytes, flops=flops, bytes_ms=b_ms, flops_ms=f_ms,
                ms=max(b_ms, f_ms),
                bound_by="bytes" if b_ms >= f_ms else "operations")


def __getattr__(name: str):
    """``LAUNCHES``: K4 launches since import or the last
    ``reset_launches``."""
    if name == "LAUNCHES":
        return sum(counts(COUNTER, _reset_at).values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    """Count the launches from now."""
    _reset_at.clear()
    _reset_at.update(counts(COUNTER))
