"""K2, the plane Gauss-Seidel sweep: the hand-written CUDA kernel and its
plain twin.

What it computes is the JAX package's ``solve/precond.py::
plane_gs_layered`` applied to r (values V (bs, bs, 3, E, Lp), plane-major
vectors (Lp, n2d, bs), bs = 4).  Downstream, for each plane l in order:

    rhs = m (r_l - Vm_l x_{l-1}) + (1 - m) r_l,     x = Dinv_l rhs,
    then ``inner_sweeps`` times
    x += Dinv_l [(rhs - V0_l (m x)) m + (1 - m) (rhs - x)],

with Vm_l / V0_l the plane's 2D products with the delta = -1 / 0 value
slices, m the plane's 0/1 dof mask, Dinv_l the inverses of its projected
diagonal blocks and x_{-1} = 0.  With ``symmetric`` the upstream sweep
follows, l = Lp-1 .. 0, with Vp (delta = +1) and x_{l+1} of the upstream
sweep, starting each plane's relaxation from its downstream result.

* ``PlaneGSOperand`` is what the V-cycle calls: built once per values
  tensor, it lays the three coupling slices out plane-major,
  (3, Lp, E, bs, bs), so that one plane's pairs are contiguous (in the
  JAX layout the planes are the fastest axis), optionally in a narrower
  value dtype, with the block inverses (Lp, n2d, bs, bs) in the same
  dtype and the mask in the iterate's.  On a CUDA tensor a call
  launches ``csrc/plane_gs.cu`` (both directions in one launch; it
  replaces the ``lax.scan``s of the JAX function, which is jnp code and
  not a Pallas kernel); on a CPU tensor it runs the plain version on the
  same prepared operand.  There is no fallback from the kernel.
* ``plane_gs_plain`` is the JAX function's algorithm in PyTorch ops on
  the prepared operand: a loop over planes, ``index_add_`` for
  ``segment_sum``.

Type pairs (values, iterate): (f64, f64), (f32, f32) and (bf16, f32).
With bf16 values the kernel and the plain version read bf16 values and
inverses and compute in float32; the JAX package rounds the whole sweep
(iterate included) to bf16, so the two agree to bf16 accuracy only.  r
is cast to the iterate's type and the result back to r's.

The kernel is built at first use with ``nvcc`` into
``build/torch_kernels/`` (utils/nvcc.py).  ``LAUNCHES`` and
``LAUNCHES_BY_DTYPES`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..utils import nvcc

LAUNCHES = 0          # kernel launches since import (or the last reset)
# the same launches by (values dtype, iterate dtype)
LAUNCHES_BY_DTYPES: Dict[Tuple[torch.dtype, torch.dtype], int] = {}

_BS = 4
_VTYPE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_LIB: Optional[ctypes.CDLL] = None


class _Params(ctypes.Structure):
    """The kernel's ``Params``: the prepared operand, fixed per build."""
    _fields_ = [("vals", ctypes.c_void_p), ("dinv", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("cols", ctypes.c_void_p),
                ("row_ptr", ctypes.c_void_p), ("vtype", ctypes.c_int),
                ("n2d", ctypes.c_int), ("Lp", ctypes.c_int),
                ("E", ctypes.c_int), ("inner_sweeps", ctypes.c_int),
                ("symmetric", ctypes.c_int)]


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib, = nvcc.build("plane_gs")
        lib.plane_gs.restype = ctypes.c_int
        lib.plane_gs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.POINTER(_Params)]
        _LIB = lib
    return _LIB


class PlaneGSOperand:
    """K2's prepared operand: r -> the plane-GS sweep's x.

    values: (bs, bs, 3, E, Lp) canonical values (level 0 unprojected: the
    sweep is mask-composed); ``dtype`` stores the value slices and block
    inverses in it (the inverses are taken from the values in their own
    dtype promoted with the mask's, then cast).  cols (E,) and row_ptr
    (n2d + 1,) are the row-sorted pair list (int64); diag_pos (n2d,) the
    self-pairs; mask (Lp*n2d*bs,) the 0/1 dof mask.
    """

    def __init__(self, values: torch.Tensor, cols: torch.Tensor,
                 row_ptr: torch.Tensor, diag_pos: torch.Tensor,
                 mask: torch.Tensor, n2d: int, inner_sweeps: int = 2,
                 symmetric: bool = True,
                 dtype: Optional[torch.dtype] = None):
        from .precond import projected_diag_inverse

        if values.dim() != 5 or tuple(values.shape[:3]) != (_BS, _BS, 3):
            raise ValueError(f"plane_gs: values must be ({_BS}, {_BS}, 3, "
                             f"E, Lp), got {tuple(values.shape)}")
        vdtype = dtype or values.dtype
        if vdtype not in _VTYPE:
            raise TypeError(f"plane_gs: unsupported values dtype {vdtype}")
        E, Lp, n2d = int(values.shape[3]), int(values.shape[4]), int(n2d)
        if tuple(cols.shape) != (E,) or tuple(row_ptr.shape) != (n2d + 1,) \
                or tuple(mask.shape) != (Lp * n2d * _BS,):
            raise ValueError(f"plane_gs: cols must be ({E},), row_ptr "
                             f"({n2d + 1},) and mask ({Lp * n2d * _BS},)")
        if cols.dtype != torch.int64 or row_ptr.dtype != torch.int64:
            raise TypeError("plane_gs: cols and row_ptr must be int64")
        if inner_sweeps < 0:
            raise ValueError("plane_gs: inner_sweeps must be >= 0")
        dev = values.device
        for name, t in (("cols", cols), ("row_ptr", row_ptr),
                        ("diag_pos", diag_pos), ("mask", mask)):
            if t.device != dev:
                raise ValueError(f"plane_gs: {name} is on {t.device}, "
                                 f"values on {dev}")
        self.device, self.n2d, self.E, self.Lp = dev, n2d, E, Lp
        self.inner_sweeps, self.symmetric = int(inner_sweeps), bool(symmetric)
        # the iterate and every sum: float64 with float64 values, else
        # float32
        self.vdtype = vdtype
        self.adtype = torch.float64 if vdtype == torch.float64 \
            else torch.float32
        self.cols, self.row_ptr = cols.contiguous(), row_ptr.contiguous()
        counts = self.row_ptr[1:] - self.row_ptr[:-1]
        self.row_ids = torch.repeat_interleave(
            torch.arange(n2d, device=dev), counts, output_size=E)
        src = values.to(vdtype) if dtype is not None else values
        mb = mask.reshape(Lp, n2d, _BS)
        self.dinv = projected_diag_inverse(src, diag_pos, mb) \
            .to(vdtype).contiguous()                       # (Lp, n2d, 4, 4)
        # (3, Lp, E, bs, bs): d = 0 couples x[l-1], 1 x[l], 2 x[l+1]
        self.values = src.permute(2, 4, 3, 0, 1).to(vdtype).contiguous()
        self.mask = mask.to(self.adtype).contiguous()
        self.shape = (Lp * n2d * _BS,)
        self._cuda = dev.type == "cuda"
        if self._cuda:
            self._fn = build().plane_gs
            self._dev_index = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            self._pstruct = _Params(
                self.values.data_ptr(), self.dinv.data_ptr(),
                self.mask.data_ptr(), self.cols.data_ptr(),
                self.row_ptr.data_ptr(), _VTYPE[vdtype], n2d, Lp, E,
                self.inner_sweeps, int(self.symmetric))
            self._params = ctypes.byref(self._pstruct)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if not r.is_floating_point() or r.shape != self.shape \
                or r.device != self.device:
            raise ValueError(
                f"plane_gs: r must be a floating {self.shape} tensor on "
                f"{self.device}, got {r.dtype} {tuple(r.shape)} on "
                f"{r.device}")
        if not self._cuda:
            return plane_gs_plain(self, r)
        global LAUNCHES
        rr = r.to(self.adtype).contiguous()
        x = torch.empty_like(rr)
        scratch = torch.empty(2 * self.n2d * _BS, dtype=self.adtype,
                              device=self.device)
        if torch.cuda.current_device() != self._dev_index:
            with torch.cuda.device(self._dev_index):
                err = self._launch(rr, x, scratch)
        else:
            err = self._launch(rr, x, scratch)
        if err != 0:
            raise RuntimeError(f"plane_gs: launch failed (cudaError {err})")
        LAUNCHES += 1
        key = (self.vdtype, self.adtype)
        LAUNCHES_BY_DTYPES[key] = LAUNCHES_BY_DTYPES.get(key, 0) + 1
        return x.to(r.dtype)

    def _launch(self, r, x, scratch) -> int:
        return self._fn(r.data_ptr(), x.data_ptr(), scratch.data_ptr(),
                        torch._C._cuda_getCurrentRawStream(self._dev_index),
                        self._params)


def plane_gs_plain(op: PlaneGSOperand, r: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (the JAX ``plane_gs_layered`` algorithm)
    on the prepared operand, computing in the operand's iterate type."""
    bs, n2d, Lp, at = _BS, op.n2d, op.Lp, op.adtype
    rb = r.to(at).reshape(Lp, n2d, bs)
    mb = op.mask.reshape(Lp, n2d, bs)

    def spmv2d(d, l, x2d):
        contrib = (op.values[d, l].to(at) * x2d[op.cols][:, None, :]) \
            .sum(dim=-1)                                 # (E, bs)
        return x2d.new_zeros((n2d, bs)).index_add_(0, op.row_ids, contrib)

    def dmv(l, v):
        return (op.dinv[l].to(at) * v[:, None, :]).sum(dim=-1)

    def relax(l, rhs, x):
        ml = mb[l]
        for _ in range(op.inner_sweeps):
            res = (rhs - spmv2d(1, l, x * ml)) * ml + (1.0 - ml) * (rhs - x)
            x = x + dmv(l, res)
        return x

    def rhs_of(d, l, x_nb):
        rl, ml = rb[l], mb[l]
        rhs = rl if x_nb is None else rl - spmv2d(d, l, x_nb)
        return ml * rhs + (1.0 - ml) * rl

    X, x = [], None
    for l in range(Lp):
        rhs = rhs_of(0, l, x)
        x = relax(l, rhs, dmv(l, rhs))
        X.append(x)
    if op.symmetric:
        x = None
        for l in reversed(range(Lp)):
            x = relax(l, rhs_of(2, l, x), X[l])
            X[l] = x
    return torch.stack(X).reshape(-1).to(r.dtype)


def reset_launches() -> None:
    """Set the launch counts to 0."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_DTYPES.clear()
