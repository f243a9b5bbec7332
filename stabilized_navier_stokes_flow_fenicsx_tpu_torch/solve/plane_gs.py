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
  launches ``csrc/plane_gs.cu`` (both directions in one launch of one
  thread-block cluster; it replaces the ``lax.scan``s of the JAX
  function, which is jnp code and not a Pallas kernel); on a CPU tensor
  it runs the plain version on the same prepared operand.  There is no
  fallback from the kernel.
* ``make_plan`` is the kernel's launch plan, built on the host once per
  operand: the cluster size, the 2D rows cut into one contiguous range
  per block (balanced by pairs), each pair's column coded as (owner
  block, row within it), the threads per block and the shared-memory
  layout (``smem_bytes``, the kernel's ``layout()``).
* ``plane_gs_plain`` is the JAX function's algorithm in PyTorch ops on
  the prepared operand: a loop over planes, ``index_add_`` for
  ``segment_sum``.

Type pairs (values, iterate): (f64, f64), (f32, f32) and (bf16, f32).
With bf16 values the kernel and the plain version read bf16 values and
inverses and compute in float32; the JAX package rounds the whole sweep
(iterate included) to bf16, so the two agree to bf16 accuracy only.  r
is cast to the iterate's type and the result back to r's.

The kernel is built at first use with ``nvcc`` into
``build/torch_kernels/`` (utils/nvcc.py).  Each launch adds one to the
tracer's counter ``k2_launch`` under its shape (E, Lp, n2d, values
dtype, iterate dtype, inner_sweeps, symmetric; utils/profiling.py);
``LAUNCHES`` and ``LAUNCHES_BY_DTYPES`` read it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..assemble.layered_spmv import dtype_name, launch_attr
from ..utils import nvcc
from ..utils.profiling import count, counts, read

COUNTER = "k2_launch"
_reset_at: Dict = {}      # the counter at the last ``reset_launches``

CLUSTER_SIZES = (1, 2, 4, 8, 16)   # 16 needs the non-portable size
SMEM_LIMIT = 232_448               # dynamic shared memory a block may take
MAX_THREADS = 512                  # per block (the kernel's launch bound)
MAX_SLOTS = 4                      # the value ring's deepest

_BS = 4
_VTYPE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_LIB: Optional[ctypes.CDLL] = None


class _Params(ctypes.Structure):
    """The kernel's ``Params``: the prepared operand and its plan."""
    _fields_ = [("vals", ctypes.c_void_p), ("dinv", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("blocks", ctypes.c_void_p),
                ("row_ptr", ctypes.c_void_p), ("colcode", ctypes.c_void_p),
                ("vtype", ctypes.c_int), ("n2d", ctypes.c_int),
                ("Lp", ctypes.c_int), ("E", ctypes.c_int),
                ("inner_sweeps", ctypes.c_int), ("symmetric", ctypes.c_int),
                ("cluster", ctypes.c_int), ("split", ctypes.c_int),
                ("threads", ctypes.c_int), ("max_rows", ctypes.c_int),
                ("max_pairs", ctypes.c_int), ("slots", ctypes.c_int)]


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = nvcc.kernel("plane_gs")
        P = ctypes.POINTER(_Params)
        lib.plane_gs.restype = ctypes.c_int
        lib.plane_gs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, P]
        lib.plane_gs_max_clusters.restype = ctypes.c_int
        lib.plane_gs_max_clusters.argtypes = [P]
        lib.plane_gs_barrier_chain.restype = ctypes.c_int
        lib.plane_gs_barrier_chain.argtypes = [ctypes.c_void_p, P,
                                               ctypes.c_int]
        _LIB = lib
    return _LIB


def smem_bytes(max_rows: int, max_pairs: int, slots: int, vsize: int,
               asize: int) -> int:
    """Dynamic shared memory of one block (csrc/plane_gs.cu's
    ``layout()``, which sizes the launch): the mbarriers, the block's column codes and row
    pointers, six iterate buffers, two plane slots (inverses, mask, r)
    and ``slots`` value slices."""
    def up16(b):
        return (b + 15) // 16 * 16
    return ((MAX_SLOTS + 2) * 8 + up16(4 * max_pairs)
            + up16(4 * (max_rows + 1)) + 6 * 4 * max_rows * asize
            + 2 * max_rows * (16 * vsize + 8 * asize)
            + slots * 16 * vsize * max_pairs)


@dataclass(frozen=True)
class Plan:
    """K2's launch plan for one operand."""
    cluster: int            # blocks in the cluster
    blocks: np.ndarray      # (cluster, 4) int32: row0, row1, pair0, pair1
    colcode: Optional[np.ndarray]  # (E,) int32: owner block | local
                                   # row << 4 (None while ranked)
    split: int              # threads per (row, component)
    threads: int            # per block
    max_rows: int
    max_pairs: int
    slots: int              # value ring depth; 0 = values from memory
    smem_bytes: int

    @property
    def staged(self) -> bool:
        """Whether the value slices are staged in shared memory."""
        return self.slots > 0


def partition(row_ptr: np.ndarray, cluster: int) -> np.ndarray:
    """(cluster, 4) int32 (row0, row1, pair0, pair1): the rows cut into
    ``cluster`` contiguous ranges of about E / cluster pairs each (a
    range is empty where there are fewer rows than blocks)."""
    rp = np.asarray(row_ptr, np.int64)
    n2d, E = len(rp) - 1, int(rp[-1])
    cuts = np.searchsorted(rp, np.arange(1, cluster) * (E / cluster))
    b = np.concatenate([[0], np.clip(cuts, 0, n2d), [n2d]])
    b = np.maximum.accumulate(b)
    return np.stack([b[:-1], b[1:], rp[b[:-1]], rp[b[1:]]], 1) \
        .astype(np.int32)


def column_codes(blocks: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """(E,) int32: each pair's column as owner block | row within it << 4."""
    starts = blocks[:, 0].astype(np.int64)
    cols = np.asarray(cols, np.int64)
    owner = np.searchsorted(starts, cols, side="right") - 1
    return (owner | (cols - starts[owner]) << 4).astype(np.int32)


def make_plan(row_ptr: np.ndarray, cols: np.ndarray, vsize: int, asize: int,
              cluster: Optional[int] = None,
              schedulable: Optional[Callable[[Plan], bool]] = None) -> Plan:
    """The launch plan for value / iterate element sizes ``vsize`` /
    ``asize``.  ``cluster`` None: the largest size of ``CLUSTER_SIZES``
    whose blocks can stage a ring of at least two value slices in shared
    memory, else the largest that fits with the values read from device
    memory (on an H100, 16 blocks beat fewer at every level of the
    lc=0.04 channel: PERF.md, profile_torch_k2.py); a given ``cluster``
    takes that size.  The ring is as deep as fits, up to ``MAX_SLOTS``;
    ``split`` (threads per row and component) is the largest that keeps
    a stage in one pass of ``MAX_THREADS`` threads, else 1, and then a
    stage takes more than one pass of the block (the kernel loops; level
    0 of bench.py's problem, 173 rows a block, takes two).
    ``schedulable(plan)``
    (the card's occupancy query, which needs no column codes; None: every
    plan) rules sizes out.  Raises ValueError for a size outside
    ``CLUSTER_SIZES`` or one whose blocks do not fit, RuntimeError when no
    size is schedulable."""
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"plane_gs: cluster must be one of {CLUSTER_SIZES},"
                         f" got {cluster}")
    staged, unstaged = [], []
    for C in (CLUSTER_SIZES if cluster is None else (cluster,)):
        blocks = partition(row_ptr, C)
        max_rows = int((blocks[:, 1] - blocks[:, 0]).max())
        max_pairs = int((blocks[:, 3] - blocks[:, 2]).max())
        split = next(k for k in (4, 2, 1)
                     if 4 * max_rows * k <= MAX_THREADS or k == 1)
        threads = min(MAX_THREADS, max(32, -(-4 * max_rows * split // 32)
                                       * 32))
        for slots in (4, 3, 2, 0):
            nbytes = smem_bytes(max_rows, max_pairs, slots, vsize, asize)
            if nbytes <= SMEM_LIMIT:
                plan = Plan(C, blocks, None, split, threads, max_rows,
                            max_pairs, slots, nbytes)
                (staged if slots else unstaged).append(plan)
                break
    candidates = staged[::-1] + unstaged[::-1]
    if not candidates:
        raise ValueError(
            f"plane_gs: {len(row_ptr) - 1} rows and {int(row_ptr[-1])} "
            f"pairs do not fit the shared memory of "
            f"{'a cluster of ' + str(cluster) if cluster else 'any cluster'}"
            f" ({SMEM_LIMIT} bytes a block)")
    for plan in candidates:
        if schedulable is None or schedulable(plan):
            return replace(plan, colcode=column_codes(plan.blocks, cols))
    raise RuntimeError(
        f"plane_gs: no cluster of {[p.cluster for p in candidates]} blocks "
        f"can be scheduled on this card")


class PlaneGSOperand:
    """K2's prepared operand: r -> the plane-GS sweep's x.

    values: (bs, bs, 3, E, Lp) canonical values (level 0 unprojected: the
    sweep is mask-composed); ``dtype`` stores the value slices and block
    inverses in it (the inverses are taken from the values in their own
    dtype promoted with the mask's, then cast).  cols (E,) and row_ptr
    (n2d + 1,) are the row-sorted pair list (int64); diag_pos (n2d,) the
    self-pairs; mask (Lp*n2d*bs,) the 0/1 dof mask.  ``cluster`` sets the
    kernel's cluster size (None: ``make_plan``'s choice); ``plan`` (built
    on the card with the operand, elsewhere at first use) raises for a
    size outside ``CLUSTER_SIZES`` or, on the card, one that cannot be
    scheduled.
    """

    def __init__(self, values: torch.Tensor, cols: torch.Tensor,
                 row_ptr: torch.Tensor, diag_pos: torch.Tensor,
                 mask: torch.Tensor, n2d: int, inner_sweeps: int = 2,
                 symmetric: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 cluster: Optional[int] = None):
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
        self.cluster = cluster
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
            # the launch's shape, the key of its count
            self._key = (E, Lp, n2d, dtype_name(vdtype),
                         dtype_name(self.adtype), self.inner_sweeps,
                         self.symmetric)
            self._dev_index = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            plan = self.plan
            self._tables = (torch.as_tensor(plan.blocks, device=dev),
                            self.row_ptr.to(torch.int32),
                            torch.as_tensor(plan.colcode, device=dev))
            self._pstruct = self._params(plan, self._tables)
            self._params_ref = ctypes.byref(self._pstruct)

    @functools.cached_property
    def plan(self) -> Plan:
        """The kernel's launch plan (built on the CPU too, where nothing
        launches; on the card only a schedulable plan is taken)."""
        schedulable = None
        if self._cuda:
            lib = build()

            def schedulable(plan):
                with torch.cuda.device(self._dev_index):
                    n = lib.plane_gs_max_clusters(
                        ctypes.byref(self._params(plan)))
                if n < 0:
                    raise RuntimeError(f"plane_gs: occupancy query failed "
                                       f"(cudaError {-n})")
                return n >= 1
        return make_plan(read(self.row_ptr, torch.Tensor.cpu).numpy(),
                         read(self.cols, torch.Tensor.cpu).numpy(),
                         self.values.element_size(),
                         self.mask.element_size(), self.cluster, schedulable)

    @property
    def stages(self) -> int:
        """Dependent stages of one sweep (each ends in a cluster barrier):
        the coupling and the inner passes of every plane and direction."""
        return (2 if self.symmetric else 1) * self.Lp \
            * (1 + self.inner_sweeps)

    def _params(self, plan: Plan, tables=None) -> _Params:
        """The kernel's Params for ``plan``; without the device ``tables``
        (blocks, row_ptr, colcode) only for the occupancy query."""
        ptrs = [t.data_ptr() for t in tables] if tables else [None] * 3
        return _Params(
            self.values.data_ptr(), self.dinv.data_ptr(),
            self.mask.data_ptr(), *ptrs,
            _VTYPE[self.vdtype], self.n2d, self.Lp, self.E,
            self.inner_sweeps, int(self.symmetric), plan.cluster, plan.split,
            plan.threads, plan.max_rows, plan.max_pairs, plan.slots)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if not r.is_floating_point() or r.shape != self.shape \
                or r.device != self.device:
            raise ValueError(
                f"plane_gs: r must be a floating {self.shape} tensor on "
                f"{self.device}, got {r.dtype} {tuple(r.shape)} on "
                f"{r.device}")
        if not self._cuda:
            return plane_gs_plain(self, r)
        rr = r.to(self.adtype).contiguous()
        if rr.data_ptr() % 16:          # the bulk copies want 16 bytes
            rr = rr.clone()
        x = torch.empty_like(rr)
        if torch.cuda.current_device() != self._dev_index:
            with torch.cuda.device(self._dev_index):
                err = self._launch(rr, x)
        else:
            err = self._launch(rr, x)
        if err != 0:
            raise RuntimeError(
                f"plane_gs: launch failed (cudaError {err}; cluster of "
                f"{self.plan.cluster} blocks, {self.plan.threads} threads, "
                f"{self.plan.smem_bytes} bytes of shared memory each)")
        count(COUNTER, key=self._key)
        return x.to(r.dtype)

    def _launch(self, r, x) -> int:
        return self._fn(r.data_ptr(), x.data_ptr(),
                        torch._C._cuda_getCurrentRawStream(self._dev_index),
                        self._params_ref)

    def barrier_chain(self) -> None:
        """Launch the plan's cluster running the sweep's ``stages``
        cluster barriers and nothing else (the chain's floor; not a K2
        launch, so not counted)."""
        if not self._cuda:
            raise RuntimeError("plane_gs: the barrier chain runs on the card")
        with torch.cuda.device(self._dev_index):
            err = build().plane_gs_barrier_chain(
                torch._C._cuda_getCurrentRawStream(self._dev_index),
                self._params_ref, self.stages + 1)
        if err != 0:
            raise RuntimeError(f"plane_gs: barrier chain launch failed "
                               f"(cudaError {err})")


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


def __getattr__(name: str):
    """``LAUNCHES`` and ``LAUNCHES_BY_DTYPES`` (by (values dtype, iterate
    dtype)): K2 launches since import or the last ``reset_launches``."""
    return launch_attr(COUNTER, _reset_at, name)


def reset_launches() -> None:
    """Count the launches from now."""
    _reset_at.clear()
    _reset_at.update(counts(COUNTER))
