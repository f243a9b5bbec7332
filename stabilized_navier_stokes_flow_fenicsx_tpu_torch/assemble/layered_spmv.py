"""K1, the layered SpMV: the hand-written CUDA kernel and its plain twin.

y = A x on the plane-block-tridiagonal layered operator,

    y[l, i, c] = sum_{e: row(e)=i} sum_{j, d} V[c, j, d, e, l]
                 * x[l + d - 1, col(e), j],        x[-1] = x[Lp] = 0,

with values V (bs, bs, 3, E, Lp) and plane-major x, y (Lp * n2d * bs,);
optionally with the Dirichlet projection fused in: m * A (m * x) +
(1 - m) * x for a 0/1 dof mask m.

* ``LayeredOperand`` is what the solver calls.  It is built once per
  values tensor: it lays the values out pair-major, (E, 48, Lp_pad) with
  zero planes from Lp to Lp_pad (the kernel's layout; ``kernel_layout``),
  optionally casting them in the same copy, and checks device, dtypes,
  shapes and contiguity there.  A call checks only x's dtype, shape and
  device: on a CUDA tensor it launches ``csrc/layered_spmv.cu`` (it
  replaces the TPU kernel ``assemble/pallas_spmv.py::_spmv_kernel``; the
  source says what bounds it and what its design does about that), on a
  CPU tensor it runs the plain version on the same prepared operand.
  There is no fallback from the kernel.
* ``layered_matvec_plain`` is the JAX package's ``layered_matvec``
  algorithm in PyTorch on the prepared operand (``index_add_`` for
  ``segment_sum``): with values narrower than x, x is cast to the values
  dtype, the product is taken in that dtype and the sum in x's dtype.
  The kernel takes the products in x's dtype after rounding x to the
  values dtype.

The kernel is built at first use with ``nvcc`` from the package's own
source into ``build/torch_kernels/`` of the checkout (utils/nvcc.py;
route: a shared library with a plain C interface, loaded with ctypes).
Each launch adds one to the tracer's counter ``k1_launch`` under its
shape (E, Lp, n2d, values dtype, x dtype, masked; utils/profiling.py);
``LAUNCHES`` and ``LAUNCHES_BY_DTYPES`` read it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..utils import nvcc
from ..utils.profiling import count, counts

COUNTER = "k1_launch"
_reset_at: Dict = {}      # the counter at the last ``reset_launches``

_BS = 4
_NROW = 3 * _BS * _BS     # value rows of one pair
_VTYPE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_ATYPE = {torch.float64: 0, torch.float32: 1}
PAIRS = 12            # the kernel's PAIRS: pairs staged per sync, and
                      # the most teams a block runs
# launch shape (``launch_shape``), tuned at lc=0.04 (PERF.md): the
# threads of a block's teams together, at most (64: one team of a
# level-0 row per block), and the bytes a thread loads per value row
BLOCK_THREADS = 64
VEC_BYTES = 8
MAX_TEAM = 512        # the kernel's MAX_THREADS
_LIB: Optional[ctypes.CDLL] = None


class _Params(ctypes.Structure):
    """The kernel's ``Params``: what a launch needs besides x, y and the
    mask, fixed per prepared operand."""
    _fields_ = [("vals", ctypes.c_void_p), ("cols", ctypes.c_void_p),
                ("row_ptr", ctypes.c_void_p), ("vtype", ctypes.c_int),
                ("n2d", ctypes.c_int), ("Lp", ctypes.c_int),
                ("Lp_pad", ctypes.c_int), ("ppt", ctypes.c_int),
                ("teams", ctypes.c_int)]


def padded_planes(Lp: int, dtype: torch.dtype) -> int:
    """Lp rounded up so that a plane row of the kernel layout is a whole
    number of 16-byte vectors (8 planes in bf16, 4 in f32, 2 in f64)."""
    q = 16 // torch.tensor([], dtype=dtype).element_size()
    return -(-Lp // q) * q


def kernel_layout(values: torch.Tensor, Lp_pad: int,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(bs, bs, 3, E, Lp) -> (E, 48, Lp_pad) in ``dtype`` (default: the
    values'), row (c * 4 + j) * 3 + d, planes Lp.. zero; one copy."""
    E, Lp = values.shape[3], values.shape[4]
    out = values.new_zeros((E, _NROW, Lp_pad), dtype=dtype or values.dtype)
    out[:, :, :Lp] = values.reshape(_NROW, E, Lp).permute(1, 0, 2)
    return out


def project_values(values: torch.Tensor, mask: torch.Tensor,
                   cols: torch.Tensor, row_ids: torch.Tensor, n2d: int,
                   Lp: int) -> torch.Tensor:
    """P A P on the value tensor (bs, bs, 3, E, Lp): rows scaled by the
    row-dof mask, cols by the (plane-shifted) col-dof mask.  For a 0/1
    mask, m * A (m * x) = (P A P) x exactly."""
    mb = mask.reshape(Lp, n2d, _BS)
    mrow = mb[:, row_ids, :].permute(2, 1, 0)        # (bs, E, Lp)
    mcol = mb[:, cols, :].permute(2, 1, 0)           # (bs, E, Lp)
    zero = torch.zeros_like(mcol[:, :, :1])
    mcol_m = torch.cat([zero, mcol[..., :-1]], dim=-1)
    mcol_p = torch.cat([mcol[..., 1:], zero], dim=-1)
    mcol_d = torch.stack([mcol_m, mcol, mcol_p], dim=1)   # (bs, 3, E, Lp)
    return values * mrow[:, None, None, :, :] * mcol_d[None]


def launch_shape(Lp_pad: int, vdtype: torch.dtype,
                 xdtype: torch.dtype) -> Tuple[int, int]:
    """(planes per thread, teams per block) of a launch.  A thread reads
    a ``VEC_BYTES`` vector per value row (4 planes in bf16, 1 in f64), or
    fewer planes where their x-typed accumulators would pass 32 bytes;
    more planes only where a team (4 * Lp_pad / ppt threads) would pass
    ``MAX_TEAM``.  As many teams as fit in ``BLOCK_THREADS`` (at least 1,
    at most ``PAIRS``).  Raises when no team of at most ``MAX_TEAM``
    threads covers the planes."""
    vsize = torch.tensor([], dtype=vdtype).element_size()
    asize = torch.tensor([], dtype=xdtype).element_size()
    ppt = max(1, min(VEC_BYTES // vsize, 32 // asize))
    # wider runs (at most 32 bytes, 8 planes) only to fit MAX_TEAM
    while _BS * Lp_pad // ppt > MAX_TEAM and Lp_pad % (2 * ppt) == 0 \
            and 2 * ppt <= min(8, 32 // vsize):
        ppt *= 2
    team = _BS * Lp_pad // ppt
    if team > MAX_TEAM:
        raise ValueError(f"layered_spmv: {Lp_pad} planes need a team of "
                         f"{team} threads, more than the kernel's {MAX_TEAM}")
    return ppt, max(1, min(PAIRS, BLOCK_THREADS // team))


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = nvcc.kernel("layered_spmv")
        lib.layered_spmv.restype = ctypes.c_int
        lib.layered_spmv.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.POINTER(_Params)]
        _LIB = lib
    return _LIB


class LayeredOperand:
    """K1's prepared operand: x -> A x, or with ``mask`` the projected
    m * A (m * x) + (1 - m) * x.

    values: (bs, bs, 3, E, Lp) canonical values; ``dtype`` casts them in
    the layout copy (the V-cycle's bf16 levels).  cols (E,) and row_ptr
    (n2d + 1,) are the row-sorted pair list (int64).  mask: (Lp*n2d*bs,)
    0/1 floating mask, kept in float64 and float32 for x of either type
    and folded into the layout (``project_values``).
    """

    def __init__(self, values: torch.Tensor, cols: torch.Tensor,
                 row_ptr: torch.Tensor, n2d: int,
                 mask: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None):
        if values.dim() != 5 or tuple(values.shape[:3]) != (_BS, _BS, 3):
            raise ValueError(f"layered_spmv: values must be ({_BS}, {_BS}, "
                             f"3, E, Lp), got {tuple(values.shape)}")
        vdtype = dtype or values.dtype
        if vdtype not in _VTYPE:
            raise TypeError(f"layered_spmv: unsupported values dtype "
                            f"{vdtype}")
        E, Lp = int(values.shape[3]), int(values.shape[4])
        n2d = int(n2d)
        if tuple(cols.shape) != (E,) or tuple(row_ptr.shape) != (n2d + 1,):
            raise ValueError(f"layered_spmv: cols must be ({E},) and "
                             f"row_ptr ({n2d + 1},)")
        if cols.dtype != torch.int64 or row_ptr.dtype != torch.int64:
            raise TypeError("layered_spmv: cols and row_ptr must be int64")
        dev = values.device
        named = [("cols", cols), ("row_ptr", row_ptr)]
        if mask is not None:
            if tuple(mask.shape) != (Lp * n2d * _BS,) \
                    or not mask.is_floating_point():
                raise ValueError(f"layered_spmv: mask must be a floating "
                                 f"({Lp * n2d * _BS},) tensor")
            named.append(("mask", mask))
        for name, t in named:
            if t.device != dev:
                raise ValueError(f"layered_spmv: {name} is on {t.device}, "
                                 f"values on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"layered_spmv: {name} is not contiguous")
        self.device, self.n2d, self.E, self.Lp = dev, n2d, E, Lp
        self.Lp_pad = padded_planes(Lp, vdtype)
        self.cols, self.row_ptr = cols, row_ptr
        self.shape = (Lp * n2d * _BS,)
        self._row_ids = None
        self.masks = None
        if mask is not None:
            # the kernel reads P A P and needs the mask only for y
            self.masks = {t: mask.to(t) for t in _ATYPE}
            values = project_values(values, mask.to(values.dtype), cols,
                                    self.row_ids, n2d, Lp)
        self.values = kernel_layout(values, self.Lp_pad, vdtype)
        self._cuda = dev.type == "cuda"
        if self._cuda:
            self._fn = build().layered_spmv
            self._dev_index = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            # the launch's shape, the key of its count
            self._key = {a: (E, Lp, n2d, dtype_name(vdtype),
                             dtype_name(a), mask is not None)
                         for a in _ATYPE}
            # the launch's Params for x of either type
            self._pstructs = {a: _Params(
                self.values.data_ptr(), cols.data_ptr(), row_ptr.data_ptr(),
                _VTYPE[vdtype], n2d, Lp, self.Lp_pad,
                *launch_shape(self.Lp_pad, vdtype, a)) for a in _ATYPE}
            self._params = {a: ctypes.byref(p)
                            for a, p in self._pstructs.items()}
            self._mask_ptr = {a: None if mask is None
                              else self.masks[a].data_ptr() for a in _ATYPE}

    @property
    def masked(self) -> bool:
        return self.masks is not None

    @property
    def row_ids(self) -> torch.Tensor:
        """(E,) row of each pair, from row_ptr (the projection and the plain
    version)."""
        if self._row_ids is None:
            counts = self.row_ptr[1:] - self.row_ptr[:-1]
            self._row_ids = torch.repeat_interleave(
                torch.arange(self.n2d, device=self.device), counts,
                output_size=self.E)
        return self._row_ids

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype not in _ATYPE or x.shape != self.shape \
                or x.device != self.device:
            raise ValueError(
                f"layered_spmv: x must be a float64 or float32 {self.shape} "
                f"tensor on {self.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
        if not self._cuda:
            return layered_matvec_plain(self, x)
        if not x.is_contiguous():
            raise ValueError("layered_spmv: x is not contiguous")
        y = torch.empty_like(x)
        if torch.cuda.current_device() != self._dev_index:
            with torch.cuda.device(self._dev_index):
                err = self._launch(x, y)
        else:
            err = self._launch(x, y)
        if err != 0:
            raise RuntimeError(f"layered_spmv: launch failed (cudaError "
                               f"{err})")
        count(COUNTER, key=self._key[x.dtype])
        return y

    def _launch(self, x, y) -> int:
        return self._fn(x.data_ptr(), y.data_ptr(),
                        torch._C._cuda_getCurrentRawStream(self._dev_index),
                        _ATYPE[x.dtype], self._mask_ptr[x.dtype],
                        self._params[x.dtype])


def layered_matvec_plain(op: LayeredOperand,
                         x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (JAX ``layered_matvec`` algorithm) on
    the prepared operand, with its mask when it has one."""
    bs, E, Lp, Lpp, n2d = _BS, op.E, op.Lp, op.Lp_pad, op.n2d
    m = op.masks[x.dtype] if op.masked else None
    xm = x if m is None else m * x
    xgT = xm.reshape(Lp, n2d, bs)[:, op.cols, :].permute(1, 2, 0)
    xpad = xgT.new_zeros((E, bs, Lpp + 2))         # planes -1 .. Lp_pad
    xpad[:, :, 1:Lp + 1] = xgT
    if op.values.dtype != x.dtype:
        xpad = xpad.to(op.values.dtype)
    xs = torch.stack([xpad[..., d:d + Lpp] for d in range(3)],
                     dim=2)                         # (E, bs j, 3, Lp_pad)
    contrib = (op.values.reshape(E, bs, bs, 3, Lpp) * xs[:, None]) \
        .sum(dim=(2, 3), dtype=x.dtype)             # (E, bs c, Lp_pad)
    y2d = torch.zeros((n2d, bs, Lpp), dtype=x.dtype, device=x.device)
    y2d.index_add_(0, op.row_ids, contrib)
    y = y2d[:, :, :Lp].permute(2, 0, 1).reshape(-1)
    return y if m is None else m * y + (1.0 - m) * x


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float64`` -> ``"float64"`` (a launch key's dtype)."""
    return str(dtype).replace("torch.", "")


def launch_attr(counter: str, since: Dict, name: str):
    """A kernel module's ``LAUNCHES``, the launches the tracer's
    ``counter`` counted after ``since`` (the counter at the module's last
    ``reset_launches``), or ``LAUNCHES_BY_DTYPES``, the same by (values
    dtype, iterate dtype): a launch key's 4th and 5th entries."""
    launches = counts(counter, since)
    if name == "LAUNCHES":
        return sum(launches.values())
    if name != "LAUNCHES_BY_DTYPES":
        raise AttributeError(f"no attribute {name!r}")
    out: Dict[Tuple[torch.dtype, torch.dtype], int] = {}
    for key, n in launches.items():
        pair = (getattr(torch, key[3]), getattr(torch, key[4]))
        out[pair] = out.get(pair, 0) + n
    return out


def __getattr__(name: str):
    """``LAUNCHES`` and ``LAUNCHES_BY_DTYPES`` (by (values dtype, x
    dtype)): K1 launches since import or the last ``reset_launches``."""
    return launch_attr(COUNTER, _reset_at, name)


def reset_launches() -> None:
    """Count the launches from now."""
    _reset_at.clear()
    _reset_at.update(counts(COUNTER))
