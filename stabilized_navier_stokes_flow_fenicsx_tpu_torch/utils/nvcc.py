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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LOGS: Dict[str, str] = {}          # nvcc/ptxas output by source name
_LIBS: Dict[str, ctypes.CDLL] = {}


def _source(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def _library_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()) \
            .hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build(*names: str) -> List[ctypes.CDLL]:
    """Compile (once per source version) and load ``csrc/<name>.cu`` for
    each name; the missing libraries are compiled in parallel.  Raises
    when there is no CUDA toolkit or a build fails."""
    todo = [n for n in names if n not in _LIBS]
    paths = {n: _library_path(n) for n in todo}
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
                 "-o", tmp, _source(n)], stdout=subprocess.PIPE,
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
        _LIBS[n] = ctypes.CDLL(paths[n])
    return [_LIBS[n] for n in names]
