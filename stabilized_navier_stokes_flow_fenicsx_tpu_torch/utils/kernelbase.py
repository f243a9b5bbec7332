"""Element kernels with runtime physical parameters.

Counterpart of the JAX package's ``utils/kernelbase.py::ElementKernel``.
The element functions (residual, analytic tangent, their cell-minor SoA
variants) are fixed per structural signature (cell, quadrature,
stabilization variant) and cached by their factories; the physical
parameters (nu, C_I, mu_T coefficient, forcing) ride in ``params`` and are
turned into tensors of the working dtype and device at every call, so one
kernel structure serves every Reynolds number.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch


def param_tensors(params, like: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Kernel parameters as tensors of ``like``'s dtype and device."""
    return tuple(torch.as_tensor(p, dtype=like.dtype, device=like.device)
                 for p in params)


@dataclasses.dataclass(frozen=True)
class ElementKernel:
    """Callable element kernel: ``kernel(coords_e, w_e) -> r_e``.

    ``kernel.jac(coords_e, w_e) -> J_e`` when an analytic tangent exists,
    else ``kernel.jac is None`` (assembly takes ``torch.func.jacfwd``).
    ``kernel.res_soa`` / ``kernel.jac_soa`` are the optional cell-minor
    variants (forms/soa.py) or None.
    """

    res_fn: Callable
    jac_fn: Optional[Callable]
    params: tuple
    soa: Optional[Tuple[Callable, Callable]] = None

    def __call__(self, coords, w):
        return self.res_fn(self.params, coords, w)

    @property
    def jac(self) -> Optional[Callable]:
        if self.jac_fn is None:
            return None
        return lambda coords, w: self.jac_fn(self.params, coords, w)

    @property
    def res_soa(self) -> Optional[Callable]:
        if self.soa is None:
            return None
        return lambda cT, wT: self.soa[0](self.params, cT, wT)

    @property
    def jac_soa(self) -> Optional[Callable]:
        if self.soa is None:
            return None
        return lambda cT, wT: self.soa[1](self.params, cT, wT)
