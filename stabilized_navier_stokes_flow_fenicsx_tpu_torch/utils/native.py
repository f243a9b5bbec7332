"""ctypes bindings for the native mesh-preprocessing library.

Builds the repository's ``csrc/meshops.cpp`` with g++ on first use into
``build/native/`` (never into ``csrc/``); every entry point has a numpy
fallback so the host layer works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _build() -> Optional[str]:
    """Compile csrc/meshops.cpp into build/native/ (named by the source's
    hash, written atomically so concurrent processes can share it)."""
    src = os.path.join(_REPO, "csrc", "meshops.cpp")
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    out_dir = os.path.join(_REPO, "build", "native")
    so = os.path.join(out_dir, f"libmeshops_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-fPIC",
                        "-std=c++17", "-shared", "-o", tmp, src],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)
    return so


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.build_pattern.restype = ctypes.c_int64
    lib.build_pattern.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p]
    lib.boundary_facets.restype = ctypes.c_int64
    lib.boundary_facets.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, i32p]
    lib.build_layered_pattern.restype = ctypes.c_int64
    lib.build_layered_pattern.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, i32p, i32p, i32p, i32p]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.split_prisms_oriented.restype = None
    lib.split_prisms_oriented.argtypes = [
        f64p, i32p, ctypes.c_int64, i32p]
    _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_pattern_native(cell_blocks: np.ndarray, n_blocks: int):
    """Returns (indptr, indices, row_ids, ell_pos, diag_pos) or None."""
    lib = load()
    if lib is None:
        return None
    cb = np.ascontiguousarray(cell_blocks, dtype=np.int32)
    nc, nbl = cb.shape
    total = nc * nbl * nbl
    ell_pos = np.empty((nc, nbl, nbl), dtype=np.int32)
    indices = np.empty(total, dtype=np.int32)
    row_ids = np.empty(total, dtype=np.int32)
    indptr = np.empty(n_blocks + 1, dtype=np.int32)
    diag_pos = np.empty(n_blocks, dtype=np.int32)
    nnz = lib.build_pattern(
        _ptr(cb), nc, nbl, n_blocks,
        _ptr(ell_pos), _ptr(indices), _ptr(row_ids), _ptr(indptr),
        _ptr(diag_pos))
    return (indptr, indices[:nnz].copy(), row_ids[:nnz].copy(),
            ell_pos, diag_pos)


def build_layered_pattern_native(cells: np.ndarray, n2d: int, Lp: int):
    """Fused layered pattern: (cols2d, rows2d, diag_pos, ell_pos, E) or
    None.  ell_pos comes back with the FINAL scatter ids
    ((delta+1)*E + pair)*Lp + l_row.  Falls back (None) without the
    library or when the dense n2d^2 pair map would exceed ~800 MB."""
    lib = load()
    if lib is None or int(n2d) * int(n2d) > 200_000_000:
        return None
    c = np.ascontiguousarray(cells, dtype=np.int32)
    nc, nbl = c.shape
    cap = min(nc * nbl * nbl, int(n2d) * int(n2d))
    ell_pos = np.empty((nc, nbl, nbl), dtype=np.int32)
    cols2d = np.empty(cap, dtype=np.int32)
    rows2d = np.empty(cap, dtype=np.int32)
    diag_pos = np.empty(n2d, dtype=np.int32)
    E = lib.build_layered_pattern(
        _ptr(c), nc, nbl, int(n2d), int(Lp),
        _ptr(ell_pos), _ptr(cols2d), _ptr(rows2d), _ptr(diag_pos))
    if E < 0:
        return None
    return (cols2d[:E].copy(), rows2d[:E].copy(), diag_pos, ell_pos,
            int(E))


def split_prisms_oriented_native(
        points: np.ndarray, prisms: np.ndarray) -> Optional[np.ndarray]:
    """Dompierre prism->tet split with positive orientation, one pass.
    Returns (3n, 4) int32 tets or None without the library."""
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    pr = np.ascontiguousarray(prisms, dtype=np.int32)
    n = pr.shape[0]
    tets = np.empty((3 * n, 4), dtype=np.int32)
    lib.split_prisms_oriented(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _ptr(pr), n, _ptr(tets))
    return tets


def boundary_facets_native(cells: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    c = np.ascontiguousarray(cells, dtype=np.int32)
    nc, nv = c.shape
    fv = nv - 1
    out = np.empty((nc * nv, fv), dtype=np.int32)
    n = lib.boundary_facets(_ptr(c), nc, nv, _ptr(out))
    return out[:n].copy()
