"""Structure-of-arrays (SoA) SUPS/LSIC element kernels.

Counterpart of the JAX package's ``forms/soa.py`` (``make_sups_soa``,
``make_ugn_soa``): every quantity is laid out cell-MINOR — scalars are
(C,) tensors, small tensors (k, C) stacks — so each elementwise op runs
over the whole cell batch.

Residual and Jacobian flow from ONE per-quadrature-point flux function.
With the per-qp state

    s_q = (u_i, du_i/dx_j, p, dp/dx_j) in R^16

the stabilized weak form pairs the test structure against a pointwise
flux f : R^16 -> R^16 (same component layout), so

    r_e = |detJ| sum_q w_q  E_q^T f(s_q)
    J_e = |detJ| sum_q w_q  E_q^T (df/ds)_q E_q

where E_q : w_e -> s_q is the interpolation operator.  df/ds is exact via
16 forward-mode JVPs of f (``torch.func.jvp`` batched by
``torch.func.vmap`` over the unit tangents, the JAX ``jax.linearize`` +
``jax.vmap``), and E_q^T / E_q never materialize: each state component
touches one basis value and three basis gradients.  For P1 the basis
gradients are constant per cell, so only (u, p) vary per qp.

These functions are the plain twin of K4 (``assemble/soa_element.py``,
``csrc/soa_element.cu``), which evaluates the same fluxes on the card: a
pair's ``flux`` and ``qdeg`` (``SoaPair``) say which.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fem.elements import element, quadrature
from ..utils.kernelbase import param_tensors

# the pointwise flux of a pair, as K4 (csrc/soa_element.cu) numbers them:
# SUPS with transposed_stab (the channel), SUPS without it, UGN
FLUX_SUPS_T, FLUX_SUPS, FLUX_UGN = 0, 1, 2
UGN_U_EPS = 1e-8        # the UGN flux's |u| guard (_ugn_flux's u_eps)

# state component indices for dim = 3:
#   0..2   u_i
#   3..11  du_i/dx_j   (3 + 3*i + j)
#   12     p
#   13..15 dp/dx_j
_M = 16


def _geometry_soa(coordsT, dtype):
    """Affine tet geometry on (12, C) transposed coordinates.

    coordsT row a*3+i = coordinate i of vertex a.  Returns (invJ [k][i]
    nested lists of (C,), absdetJ (C,)) with invJ[k][i] = d xi_k / d x_i.
    """
    x = [[coordsT[a * 3 + i].to(dtype) for i in range(3)]
         for a in range(4)]
    J = [[x[k + 1][i] - x[0][i] for k in range(3)] for i in range(3)]
    c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
    c01 = J[1][0] * J[2][2] - J[1][2] * J[2][0]
    c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
    det = J[0][0] * c00 - J[0][1] * c01 + J[0][2] * c02
    inv_det = 1.0 / det
    invJ = [
        [c00 * inv_det,
         -(J[0][1] * J[2][2] - J[0][2] * J[2][1]) * inv_det,
         (J[0][1] * J[1][2] - J[0][2] * J[1][1]) * inv_det],
        [-c01 * inv_det,
         (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * inv_det,
         -(J[0][0] * J[1][2] - J[0][2] * J[1][0]) * inv_det],
        [c02 * inv_det,
         -(J[0][0] * J[2][1] - J[0][1] * J[2][0]) * inv_det,
         (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * inv_det],
    ]
    return invJ, det.abs()


def _sups_flux(nu, C_I, G, trG, GdG, transposed_stab):
    """Pointwise SUPS/LSIC flux f : R^16 -> R^16 over (C,) lanes (Galerkin
    + SUPS + LSIC, the UFL ``dot(u, grad)`` transposed-stab quirk
    included)."""

    def f(*s):
        u = s[0:3]
        Gu = [[s[3 + 3 * i + j] for j in range(3)] for i in range(3)]
        p = s[12]
        gp = s[13:16]
        adv = [sum(Gu[i][j] * u[j] for j in range(3)) for i in range(3)]
        if transposed_stab:
            res = [sum(Gu[i][j] * u[i] for i in range(3)) + gp[j]
                   for j in range(3)]
        else:
            res = [adv[j] + gp[j] for j in range(3)]
        uGu = sum(u[i] * G[i][j] * u[j]
                  for i in range(3) for j in range(3))
        tau = torch.rsqrt(uGu + C_I * nu * nu * GdG)
        div = Gu[0][0] + Gu[1][1] + Gu[2][2]
        nu_l = 1.0 / (trG * tau)
        f_u = adv
        if transposed_stab:
            f_G = [[nu * Gu[i][j] + tau * u[i] * res[j]
                    for j in range(3)] for i in range(3)]
        else:
            f_G = [[nu * Gu[i][j] + tau * res[i] * u[j]
                    for j in range(3)] for i in range(3)]
        lsic = nu_l * div - p
        for i in range(3):
            f_G[i][i] = f_G[i][i] + lsic
        f_p = div
        f_gp = [tau * res[j] for j in range(3)]
        return tuple(f_u) + tuple(f_G[i][j] for i in range(3)
                                  for j in range(3)) + (f_p,) + tuple(f_gp)

    return f


def _ugn_flux(nu, h, u_eps, dtype):
    """Pointwise UGN/Tezduyar flux (lid-driven variant,
    forms/navier_stokes.py::make_ns_ugn_kernel): tau_SUPG from
    (tau_1, tau_3), tau_LSIC = (h/2)|u| z(Re_UGN).  h = cell diameter
    (a per-cell (C,) constant).  ``tiny`` keeps sqrt differentiable at
    u = 0, where the guard zeroes the tau_1 term."""
    tiny = torch.finfo(dtype).tiny

    def f(*s):
        u = s[0:3]
        Gu = [[s[3 + 3 * i + j] for j in range(3)] for i in range(3)]
        p = s[12]
        gp = s[13:16]
        adv = [sum(Gu[i][j] * u[j] for j in range(3)) for i in range(3)]
        res = [adv[j] + gp[j] for j in range(3)]
        u_sq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
        u_norm = torch.sqrt(u_sq + tiny)
        inv_tau1_sq = torch.where(u_norm <= u_eps, 0.0,
                                  4.0 * u_sq / (h * h))
        tau3 = h * h / (4.0 * nu)
        tau_s = torch.rsqrt(inv_tau1_sq + 1.0 / (tau3 * tau3))
        re_ugn = u_norm * h / (2.0 * nu)
        z = torch.minimum(re_ugn / 3.0, torch.ones_like(re_ugn))
        tau_l = 0.5 * h * u_norm * z
        div = Gu[0][0] + Gu[1][1] + Gu[2][2]
        f_u = adv
        f_G = [[nu * Gu[i][j] + tau_s * res[i] * u[j]
                for j in range(3)] for i in range(3)]
        lsic = tau_l * div - p
        for i in range(3):
            f_G[i][i] = f_G[i][i] + lsic
        f_p = div
        f_gp = [tau_s * res[j] for j in range(3)]
        return tuple(f_u) + tuple(f_G[i][j] for i in range(3)
                                  for j in range(3)) + (f_p,) + tuple(f_gp)

    return f


def _states(phi_np, g, wT, dtype, nq):
    """Per-cell constant gradient states + per-qp value states.

    wT row a*4 + c = component c at vertex a.  Returns
    (Gu [i][j] (C,), gp [j] (C,), u_q [q][i] (C,), p_q [q] (C,))."""
    wv = [[wT[a * 4 + i].to(dtype) for i in range(4)] for a in range(4)]
    Gu = [[sum(g[a][j] * wv[a][i] for a in range(4)) for j in range(3)]
          for i in range(3)]
    gp = [sum(g[a][j] * wv[a][3] for a in range(4)) for j in range(3)]
    u_q = [[sum(float(phi_np[q, a]) * wv[a][i] for a in range(4))
            for i in range(3)] for q in range(nq)]
    p_q = [sum(float(phi_np[q, a]) * wv[a][3] for a in range(4))
           for q in range(nq)]
    return Gu, gp, u_q, p_q


def _basis_grads(dphi0, invJ):
    """g[a][j] = sum_k dphi[a, k] invJ[k][j] — (C,) tensors (P1: the same
    at every quadrature point)."""
    return [[sum(float(dphi0[a, k]) * invJ[k][j] for k in range(3))
             for j in range(3)] for a in range(4)]


def _et_dot(phi_qa, g_a, F, alpha):
    """E^T contraction row: phi_qa * F[value_alpha] + sum_j g_a[j] *
    F[grad_alpha_j], F indexable by state id."""
    if alpha < 3:
        out = phi_qa * F[alpha]
        for j in range(3):
            out = out + g_a[j] * F[3 + 3 * alpha + j]
    else:
        out = phi_qa * F[12]
        for j in range(3):
            out = out + g_a[j] * F[13 + j]
    return out


def _flux_jacobian(flux, s):
    """(16_out, 16_in, C) df/ds: one vmapped forward-mode JVP of the flux
    over the 16 unit tangents."""
    C = s[0].shape[-1]
    tangs = [torch.zeros((_M, C), dtype=s[k].dtype, device=s[k].device)
             for k in range(_M)]
    for k in range(_M):
        tangs[k][k] = 1.0

    def column(*t):
        return torch.func.jvp(flux, tuple(s), tuple(t))[1]

    outs = torch.func.vmap(column)(*tangs)      # 16 x (16_in, C)
    return torch.stack(outs, dim=0)


def _jac_q_accum(J, flux, s, phi_q, g, w):
    """One quadrature point's w_q * E^T (df/ds) E added to J (16, 16, C)."""
    F = _flux_jacobian(flux, s)
    Fk = [F[:, k] for k in range(_M)]
    FE = torch.stack([_et_dot(float(phi_q[b]), g[b], Fk, beta)
                      for b in range(4) for beta in range(4)], dim=0)
    FEk = [FE[:, k] for k in range(_M)]
    rows = [w * _et_dot(float(phi_q[a]), g[a], FEk, alpha)
            for a in range(4) for alpha in range(4)]
    return J + torch.stack(rows, dim=0)


def _p1_tables(cell: str, qdeg: int):
    """(phi (nq, 4), the constant dphi (4, 3), weights (nq,)) of P1 on
    the tetrahedron."""
    if cell != "tetrahedron":
        raise ValueError("SoA kernels are 3D (tetrahedron) only")
    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    if not np.allclose(dphi_np, dphi_np[0]):
        raise ValueError("P1 gradients must be constant")
    return phi_np, dphi_np[0], qr.weights


class SoaPair(tuple):
    """(res_soa, jac_soa), with ``flux`` (one of FLUX_*) and ``qdeg``: the
    pointwise flux and the quadrature degree the pair evaluates."""

    def __new__(cls, res_soa, jac_soa, flux: int, qdeg: int):
        pair = super().__new__(cls, (res_soa, jac_soa))
        pair.flux, pair.qdeg = flux, qdeg
        return pair


def _soa_pair(phi_np, wq_np, setup, flux: int, qdeg: int):
    """(res_soa, jac_soa) around ``setup(params, coordsT, wT) -> (flux,
    g, detJ)``: the quadrature loops of r_e and J_e shared by every
    flux."""
    nq = phi_np.shape[0]

    def _common(params, coordsT, wT):
        flux, g, detJ = setup(params, coordsT, wT)
        Gu, gp, u_q, p_q = _states(phi_np, g, wT, wT.dtype, nq)
        gflat = tuple(Gu[i][j] for i in range(3) for j in range(3))
        states = [tuple(u_q[q]) + gflat + (p_q[q],) + tuple(gp)
                  for q in range(nq)]
        return flux, g, detJ, states

    def res_soa(params, coordsT, wT):
        flux, g, detJ, states = _common(params, coordsT, wT)
        r = [0.0] * 16
        for q in range(nq):
            f0 = flux(*states[q])
            w = float(wq_np[q])
            for a in range(4):
                for alpha in range(4):
                    r[a * 4 + alpha] = r[a * 4 + alpha] + w * _et_dot(
                        float(phi_np[q, a]), g[a], f0, alpha)
        return torch.stack(r, dim=0) * detJ[None, :]

    def jac_soa(params, coordsT, wT):
        flux, g, detJ, states = _common(params, coordsT, wT)
        C = wT.shape[-1]
        J = torch.zeros((16, 16, C), dtype=wT.dtype, device=wT.device)
        for q in range(nq):
            J = _jac_q_accum(J, flux, states[q], phi_np[q], g,
                             float(wq_np[q]))
        return J * detJ[None, None, :]

    return SoaPair(res_soa, jac_soa, flux, qdeg)


@functools.lru_cache(maxsize=None)
def make_sups_soa(cell: str, transposed_stab: bool, qdeg: int):
    """(res_soa, jac_soa) for the G-metric SUPS/LSIC kernel.

    Signatures (C = cell batch, minor axis):
      res_soa(params, coordsT (12, C), wT (16, C)) -> (16, C)
      jac_soa(params, coordsT (12, C), wT (16, C)) -> (16, 16, C)
    with row/col index a*bs + component, matching the per-cell kernels.
    """
    phi_np, dphi0, wq_np = _p1_tables(cell, qdeg)

    def setup(params, coordsT, wT):
        nu, C_I = param_tensors(params, wT)
        invJ, detJ = _geometry_soa(coordsT, wT.dtype)
        g = _basis_grads(dphi0, invJ)
        G = [[sum(invJ[k][i] * invJ[k][j] for k in range(3))
              for j in range(3)] for i in range(3)]
        trG = G[0][0] + G[1][1] + G[2][2]
        GdG = sum(G[i][j] * G[i][j] for i in range(3) for j in range(3))
        return _sups_flux(nu, C_I, G, trG, GdG, transposed_stab), g, detJ

    return _soa_pair(phi_np, wq_np, setup,
                     FLUX_SUPS_T if transposed_stab else FLUX_SUPS, qdeg)


def _diameter_soa(coordsT, dtype):
    """Cell diameter (longest edge) on (12, C) transposed coordinates."""
    x = [[coordsT[a * 3 + i].to(dtype) for i in range(3)]
         for a in range(4)]
    h2 = None
    for a in range(4):
        for b in range(a + 1, 4):
            d = sum((x[a][i] - x[b][i]) ** 2 for i in range(3))
            h2 = d if h2 is None else torch.maximum(h2, d)
    return torch.sqrt(h2)


@functools.lru_cache(maxsize=None)
def make_ugn_soa(cell: str, qdeg: int):
    """(res_soa, jac_soa) for the UGN/Tezduyar-tau kernel — same
    contract as make_sups_soa; h = cell diameter enters the flux as a
    per-cell constant."""
    phi_np, dphi0, wq_np = _p1_tables(cell, qdeg)

    def setup(params, coordsT, wT):
        (nu,) = param_tensors(params, wT)
        invJ, detJ = _geometry_soa(coordsT, wT.dtype)
        g = _basis_grads(dphi0, invJ)
        h = _diameter_soa(coordsT, wT.dtype)
        return _ugn_flux(nu, h, UGN_U_EPS, wT.dtype), g, detJ

    return _soa_pair(phi_np, wq_np, setup, FLUX_UGN, qdeg)
