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
nl, dtype, flux, entry).
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import torch

from ..forms.soa import FLUX_SUPS, FLUX_SUPS_T, FLUX_UGN, UGN_U_EPS
from ..utils import nvcc
from ..utils.profiling import count, dtype_name

if TYPE_CHECKING:
    from .structured import StructuredAsm

COUNTER = "k4_launch"
_DTYPE = {torch.float64: 0, torch.float32: 1}
_ENTRY = {"jacobian": 0, "residual": 1}
FLUX_NAMES = {FLUX_SUPS_T: "sups_t", FLUX_SUPS: "sups", FLUX_UGN: "ugn"}
QDEG = 2                  # the quadrature rule baked into the source
_LIB: Optional[ctypes.CDLL] = None


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
    count(COUNTER, key=(M3p * nl, nl, dtype_name(w.dtype), FLUX_NAMES[flux],
                        entry))
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
