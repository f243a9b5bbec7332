"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` of the package is compiled by ``nvcc`` for
``sm_90a`` into its own ``lib<name>_<tag>.so`` under ``build/torch_kernels/``
of the checkout, where the tag hashes the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  A library is
written under a temporary name and renamed, so concurrent processes can
share the directory.  The sources have a plain C interface and are
loaded with ctypes; the callers set each function's argument types.

``build(*names)`` starts one ``nvcc`` per missing library, all at once,
and waits for them; ``LOGS`` keeps each build's nvcc/ptxas output.
``kernel(name)`` is how the wrappers load their library: it builds all
of ``KERNELS`` in one ``build`` call, so a checkout's first run compiles
the package's hand kernels in parallel.  ``csrc=`` builds the sources of
another directory (an earlier version of a kernel, for comparison) the
same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LOGS: Dict[str, str] = {}          # nvcc/ptxas output by source name
# the package's hand kernels: K1, K2, K3, K4
KERNELS = ("layered_spmv", "plane_gs", "streamtrace", "soa_element")
_LIBS: Dict[str, ctypes.CDLL] = {}   # by library path


def _source(name: str, csrc: str) -> str:
    return os.path.join(csrc, f"{name}.cu")


def _library_path(name: str, csrc: str) -> str:
    with open(_source(name, csrc), "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()) \
            .hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build(*names: str, csrc: Optional[str] = None) -> List[ctypes.CDLL]:
    """Compile (once per source version) and load ``<csrc>/<name>.cu``
    (default: the package's ``csrc/``) for each name; the missing
    libraries are compiled in parallel.  Raises when there is no CUDA
    toolkit or a build fails."""
    csrc = csrc or os.path.join(_PKG, "csrc")
    paths = {n: _library_path(n, csrc) for n in names}
    todo = [n for n in names if paths[n] not in _LIBS]
    missing = [n for n in todo if not os.path.exists(paths[n])]
    if missing:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError(f"{', '.join(missing)}: no CUDA toolkit (nvcc) "
                               f"found")
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for n in missing:
            tmp = f"{paths[n]}.{os.getpid()}.tmp"
            procs[n] = (tmp, subprocess.Popen(
                [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
                 "-o", tmp, _source(n, csrc)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            LOGS[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc failed\n{LOGS[n]}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    for n in todo:
        _LIBS[paths[n]] = ctypes.CDLL(paths[n])
    return [_LIBS[paths[n]] for n in names]


def kernel(name: str) -> ctypes.CDLL:
    """The library of the package's kernel ``name`` (one of
    ``KERNELS``), building every kernel of ``KERNELS`` that is missing at
    once."""
    return build(*KERNELS)[KERNELS.index(name)]
