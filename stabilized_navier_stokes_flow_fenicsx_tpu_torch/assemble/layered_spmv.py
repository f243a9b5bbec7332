"""K1, the layered SpMV: the hand-written CUDA kernel and its plain twin.

y = A x on the plane-block-tridiagonal layered operator,

    y[l, i, c] = sum_{e: row(e)=i} sum_{j, d} V[c, j, d, e, l]
                 * x[l + d - 1, col(e), j],        x[-1] = x[Lp] = 0,

with values V (bs, bs, 3, E, Lp) and plane-major x, y (Lp * n2d * bs,).

* ``layered_matvec_plain`` is the JAX package's ``layered_matvec``
  algorithm in PyTorch (``index_add_`` for ``segment_sum``): with values
  narrower than x, x is cast to the values dtype, the product is taken in
  that dtype and the sum in x's dtype.
* ``layered_matvec_cuda`` launches ``csrc/layered_spmv.cu`` (it replaces
  the TPU kernel ``assemble/pallas_spmv.py::_spmv_kernel``; the source
  says what bounds it and what its design does about that).  The kernel
  takes the products in x's dtype after rounding x to the values dtype.
* ``layered_spmv`` is what the solver calls: the plain version for a CPU
  tensor, the kernel for a CUDA tensor, and an error for anything the
  kernel does not take.  There is no fallback from the kernel.

The kernel is built at first use with ``nvcc`` from the package's own
source into ``build/torch_kernels/`` of the checkout (route: a shared
library with a plain C interface, loaded with ctypes).  ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, Optional, Tuple

import torch

LAUNCHES = 0          # kernel launches since import (or the last reset)
# the same launches by (values dtype, x dtype)
LAUNCHES_BY_DTYPES: Dict[Tuple[torch.dtype, torch.dtype], int] = {}
BUILD_LOG = ""        # nvcc/ptxas output of the build

_BS = 4
_VTYPE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_ATYPE = {torch.float64: 0, torch.float32: 1}
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "layered_spmv.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB: Optional[ctypes.CDLL] = None


def layered_matvec_plain(values: torch.Tensor, x: torch.Tensor,
                         cols: torch.Tensor, row_ids: torch.Tensor,
                         n2d: int) -> torch.Tensor:
    """The plain PyTorch version (JAX ``layered_matvec`` algorithm)."""
    bs, _, _, E, Lp = values.shape
    out_dtype = x.dtype
    xgT = x.reshape(Lp, n2d, bs)[:, cols, :].permute(2, 1, 0)  # (bs, E, Lp)
    if values.dtype != x.dtype:
        xgT = xgT.to(values.dtype)
    zero = xgT.new_zeros((bs, E, 1))
    x_m = torch.cat([zero, xgT[..., :-1]], dim=-1)        # x[l-1] at l
    x_p = torch.cat([xgT[..., 1:], zero], dim=-1)         # x[l+1] at l
    xs = torch.stack([x_m, xgT, x_p], dim=1)              # (bs, 3, E, Lp)
    contrib = (values * xs[None]).sum(dim=(1, 2), dtype=out_dtype)
    y2d = torch.zeros((n2d, bs, Lp), dtype=out_dtype, device=x.device)
    y2d.index_add_(0, row_ids, contrib.permute(1, 0, 2))
    return y2d.permute(2, 0, 1).reshape(-1)


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    from torch.utils.cpp_extension import CUDA_HOME

    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(_NVCC_FLAGS).encode()) \
            .hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"liblayered_spmv_{tag}.so")
    if not os.path.exists(so):
        if CUDA_HOME is None:
            raise RuntimeError("layered_spmv: no CUDA toolkit (nvcc) found")
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *_NVCC_FLAGS,
             "-o", tmp, _SRC], capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"layered_spmv: nvcc failed\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.layered_spmv.restype = ctypes.c_int
    lib.layered_spmv.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _LIB = lib
    return lib


def layered_matvec_cuda(values: torch.Tensor, x: torch.Tensor,
                        cols: torch.Tensor, row_ptr: torch.Tensor,
                        n2d: int) -> torch.Tensor:
    """Launch K1 on the current stream; raises on any input the kernel
    does not take or when the launch fails."""
    global LAUNCHES
    if values.dim() != 5 or values.shape[:3] != (_BS, _BS, 3):
        raise ValueError(f"layered_spmv: values must be ({_BS}, {_BS}, 3, "
                         f"E, Lp), got {tuple(values.shape)}")
    E, Lp = int(values.shape[3]), int(values.shape[4])
    if x.shape != (Lp * n2d * _BS,):
        raise ValueError(f"layered_spmv: x must be ({Lp * n2d * _BS},), "
                         f"got {tuple(x.shape)}")
    if cols.shape != (E,) or row_ptr.shape != (n2d + 1,):
        raise ValueError("layered_spmv: cols must be (E,) and row_ptr "
                         "(n2d + 1,)")
    if values.dtype not in _VTYPE or x.dtype not in _ATYPE:
        raise TypeError(f"layered_spmv: unsupported dtypes values="
                        f"{values.dtype} x={x.dtype}")
    if cols.dtype != torch.int64 or row_ptr.dtype != torch.int64:
        raise TypeError("layered_spmv: cols and row_ptr must be int64")
    for name, t in (("values", values), ("x", x), ("cols", cols),
                    ("row_ptr", row_ptr)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"layered_spmv: {name} is on {t.device}, "
                             f"all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"layered_spmv: {name} is not contiguous")
    lib = build()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.layered_spmv(
            _VTYPE[values.dtype], _ATYPE[x.dtype], values.data_ptr(),
            x.data_ptr(), cols.data_ptr(), row_ptr.data_ptr(), y.data_ptr(),
            n2d, E, Lp, stream)
    if err != 0:
        raise RuntimeError(f"layered_spmv: launch failed (cudaError {err})")
    LAUNCHES += 1
    key = (values.dtype, x.dtype)
    LAUNCHES_BY_DTYPES[key] = LAUNCHES_BY_DTYPES.get(key, 0) + 1
    return y


def reset_launches() -> None:
    """Set the launch counts to 0."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_DTYPES.clear()


def layered_spmv(values: torch.Tensor, x: torch.Tensor, cols: torch.Tensor,
                 row_ids: torch.Tensor, row_ptr: torch.Tensor,
                 n2d: int) -> torch.Tensor:
    """y = A x: the plain version on the CPU, the kernel on the card."""
    if x.device.type == "cpu":
        return layered_matvec_plain(values, x, cols, row_ids, n2d)
    return layered_matvec_cuda(values, x, cols, row_ptr, n2d)
