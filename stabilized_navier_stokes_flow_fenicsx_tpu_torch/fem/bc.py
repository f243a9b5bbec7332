"""Dirichlet boundary conditions.

Host-side equivalent of ``dolfinx.fem.dirichletbc`` +
``locate_dofs_topological`` + the apply_lifting/set_bc dance in the SNES
callbacks (reference NavierStokes/NavierStokesChannelFlow.py:127-147, 51-67).

A BC is just (dofs, values).  Application semantics:

* nonlinear residual: ``r[dofs] = x[dofs] - values`` (so a Newton step keeps
  constrained dofs exactly at their values — same fixed point as PETSc's
  apply_lifting/set_bc with scale -1).
* Jacobian / linear operator: constrained rows and columns are projected out
  and replaced by the identity (see assemble/assembly.py), matching
  ``assemble_matrix(..., bcs=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    dofs: np.ndarray     # (m,) int32 global dof ids
    values: np.ndarray   # (m,) float values

    def __post_init__(self):
        object.__setattr__(self, "dofs", np.asarray(self.dofs, np.int32))
        object.__setattr__(
            self, "values", np.asarray(self.values, np.float64))


def combine_bcs(bcs: Sequence[DirichletBC]) -> DirichletBC:
    """Merge BCs; later entries win on duplicated dofs (dolfinx keeps first —
    the reference never overlaps markers, so order is irrelevant there)."""
    if not bcs:
        return DirichletBC(np.zeros(0, np.int32), np.zeros(0))
    dofs = np.concatenate([b.dofs for b in bcs])
    vals = np.concatenate([b.values for b in bcs])
    # keep last occurrence of each dof
    _, idx = np.unique(dofs[::-1], return_index=True)
    idx = len(dofs) - 1 - idx
    return DirichletBC(dofs[idx], vals[idx])


def bc_mask(ndofs: int, bc: DirichletBC) -> np.ndarray:
    """1.0 on free dofs, 0.0 on constrained — the projection P as a vector."""
    m = np.ones(ndofs, dtype=np.float64)
    m[bc.dofs] = 0.0
    return m


def bc_vector(ndofs: int, bc: DirichletBC) -> np.ndarray:
    """g: BC values scattered into a full-length vector (zeros elsewhere)."""
    g = np.zeros(ndofs, dtype=np.float64)
    g[bc.dofs] = bc.values
    return g
