"""Exact solutions used as test oracles.

The reference validates the duct solve by checking that the outlet is
fully-developed channel flow (reference README.md:44-56); the classical
series solution for laminar flow in a rectangular duct makes that check
quantitative.
"""

from __future__ import annotations

import numpy as np


def square_duct_profile(y, z, half_width: float = 0.5, nterms: int = 101):
    """Axial velocity u(y, z) solving -lap u = 1, u = 0 on the walls of
    the square (-a, a)^2.  Fourier series (e.g. White, Viscous Fluid Flow).
    """
    a = half_width
    y = np.asarray(y)
    z = np.asarray(z)
    u = np.zeros(np.broadcast(y, z).shape)
    for n in range(1, nterms, 2):
        k = n * np.pi / (2 * a)
        u += (
            (4 * (2 * a) ** 2 / np.pi**3)
            * (1 / n**3)
            * (-1) ** ((n - 1) // 2)
            * (1 - np.cosh(k * z) / np.cosh(k * a))
            * np.cos(k * y)
        )
    return u


def square_duct_mean(half_width: float = 0.5, nterms: int = 1001) -> float:
    """Mean of square_duct_profile over the cross-section."""
    a = half_width
    s = 0.0
    for n in range(1, nterms, 2):
        k = n * np.pi / (2 * a)
        # integral of cos(k y) over (-a,a) = 2 sin(k a)/k;  sin(ka)=(-1)^((n-1)/2)
        iy = 2 * np.sin(k * a) / k
        iz = 2 * a - 2 * np.tanh(k * a) / k
        s += (4 * (2 * a) ** 2 / np.pi**3) / n**3 * (-1) ** ((n - 1) // 2) \
            * iy * iz
    return s / (2 * a) ** 2
