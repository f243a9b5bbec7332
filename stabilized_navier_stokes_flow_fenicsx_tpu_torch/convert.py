"""The JAX package's state, as numpy copies, -> the port's equivalents.

Each function takes plain numpy data (fields by name, as the JAX
package's NamedTuples name them) and returns the port's tensors or
dataclasses on ``device``; nothing here imports jax.  The tests use it to
feed the JAX reference and the port the same operator, plan and state.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from .assemble.layered import LayeredArrays
from .assemble.structured import StructuredAsm
from .solve.mg import MGHierarchy, MGLevel


def structured_asm(fields: Mapping[str, np.ndarray], device) -> StructuredAsm:
    """``StructuredAsm`` (assemble/structured.py) from its numpy fields."""
    return StructuredAsm.from_numpy(fields, device)


def layered_arrays(fields: Mapping, device) -> LayeredArrays:
    """``LayeredArrays`` (assemble/layered.py) from its numpy fields;
    ``fields["sasm"]`` holds the ``StructuredAsm`` fields, and
    ``row_ptr`` is derived from the sorted ``row_ids``."""
    sasm = structured_asm(fields["sasm"], device)
    return LayeredArrays.from_numpy(
        {k: v for k, v in fields.items() if k != "sasm"}, sasm, device)


def mg_hierarchy(levels: Sequence[Mapping[str, np.ndarray]],
                 dims: Sequence[Tuple[int, int, int]],
                 device) -> MGHierarchy:
    """``MGHierarchy`` (solve/mg.py) from the per-level numpy fields and
    the per-level (n2d, Lp, E) dims."""
    return MGHierarchy(
        levels=tuple(MGLevel.from_numpy(lv, device) for lv in levels),
        dims=tuple(tuple(int(v) for v in d) for d in dims))


def kernel_params(params: Sequence, device,
                  dtype: torch.dtype = torch.float64) -> tuple:
    """Element-kernel parameters (nu, C_I) or (nu, mu_T_coeff, forcing)
    as tensors; pass them to the port's kernel factories."""
    return tuple(torch.tensor(np.asarray(p), dtype=dtype, device=device)
                 for p in params)


def dof_vector(w: np.ndarray, device,
               dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """A plane-major dof vector."""
    return torch.tensor(np.asarray(w), dtype=dtype, device=device)
