"""Stabilized Navier-Stokes element kernels.

Counterparts of the JAX package's ``forms/navier_stokes.py``.

1. ``make_ns_sups_kernel``: G-metric SUPS + LSIC (reference
   NavierStokesChannelFlow.py:220-266):

  G = (dxi/dx)^T (dxi/dx),  C_I = 36
  tau_SUPS = 1 / sqrt(u.Gu + C_I nu^2 G:G)
  res_M    = dot(u, grad(u)) + grad(p)        [P1: div(2 nu sym grad u)=0]
  a  = (u.nabla_grad u).v + nu grad(u):grad(v) - p div(v) + q div(u)
     + tau_SUPS res_M . (dot(u, grad(v)) + grad(q))
     + nu_LSIC div(v) div(u),   nu_LSIC = 1/(tr(G) tau_SUPS)

The UFL quirk is kept for parity: the reference's res_M and SUPG test
function use ``dot(u, grad(.))``, which contracts the component index —
(grad u)^T u.  ``transposed_stab=False`` switches to the textbook form.

The per-cell residual and its hand-derived tangent (``kernel.jac``) are
the reference the cell-minor SoA pair (forms/soa.py, ``kernel.res_soa`` /
``kernel.jac_soa``) is checked against; the structured assembly runs the
SoA pair.

2. ``make_ns_ugn_kernel``: UGN/Tezduyar tau (reference
   LidDrivenFlow/LidDrivenNavierStokesFlow.py:119-143), on triangles and
   tetrahedra:

  tau_SUPG = (tau_1^-2 + tau_3^-2)^(-1/2),  tau_1 = h/(2|u|) guarded at
  |u|<=1e-8, tau_3 = h^2/(4 nu);  Re_UGN = |u| h/(2 nu),
  z = min(Re_UGN/3, 1), tau_LSIC = (h/2) |u| z
  res = (u.nabla_grad)u + grad(p)             [P1 viscous term drops]
  a  = Galerkin + tau_SUPG (u.nabla_grad v).res + tau_SUPG grad(q).res
     + tau_LSIC div(v) div(u)

with its hand-derived tangent as ``kernel.jac``.
"""

from __future__ import annotations

import functools

import torch

from ..assemble.assembly import affine_geometry, cell_diameter
from ..fem.elements import element, quadrature
from ..utils.kernelbase import ElementKernel, param_tensors


def _assemble_blocks(J_uu, J_up, J_pu, J_pp, nv, dim, bs):
    """Pack per-block Jacobians into the interleaved (ndl, ndl) layout
    matching the node-blocked dof ordering w.reshape(nv, bs)."""
    row_u = torch.cat([J_uu, J_up[:, :, :, None]], dim=-1)
    row_p = torch.cat([J_pu[:, None, :, :], J_pp[:, None, :, None]], dim=-1)
    J = torch.cat([row_u, row_p], dim=1)            # (nv, bs, nv, bs)
    return J.reshape(nv * bs, nv * bs)


def make_ns_sups_kernel(
    cell: str,
    nu,
    C_I=36.0,
    transposed_stab: bool = True,
    qdeg: int = 2,
) -> ElementKernel:
    """SUPS/LSIC kernel on equal-order P1-P1; (nu, C_I) are runtime
    parameters.  On tetrahedra the SoA variants ride along for the
    structured assembly."""
    soa = None
    if cell == "tetrahedron":
        from .soa import make_sups_soa

        soa = make_sups_soa(cell, transposed_stab, qdeg)
    return ElementKernel(*_sups_fns(cell, transposed_stab, qdeg),
                         (nu, C_I), soa=soa)


@functools.lru_cache(maxsize=None)
def _sups_fns(cell: str, transposed_stab: bool, qdeg: int):
    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    dim = elem.dim
    nv = elem.ndof
    bs = dim + 1
    es = torch.einsum

    def _tables(w):
        dtype, dev = w.dtype, w.device
        return (torch.as_tensor(phi_np, dtype=dtype, device=dev),
                torch.as_tensor(dphi_np, dtype=dtype, device=dev),
                torch.as_tensor(qr.weights, dtype=dtype, device=dev))

    def kernel(params, coords, w):
        nu, C_I = param_tensors(params, w)
        phi, dphi, wq = _tables(w)
        coords = coords.to(w.dtype)

        _, invJ, detJ = affine_geometry(coords, dim)
        G = es("ki,kj->ij", invJ, invJ)
        trG = G[0, 0] + G[1, 1] + G[2, 2]
        GdG = (G * G).sum()

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]

        g = es("qak,ki->qai", dphi, invJ)            # (nq, nv, dim)
        u_q = es("qa,ai->qi", phi, u_n)              # (nq, dim)
        grad_u = es("qaj,ai->qij", g, u_n)           # du_i/dx_j
        grad_p = es("qai,a->qi", g, p_n)
        div_u = es("qii->q", grad_u)
        p_q = es("qa,a->q", phi, p_n)

        uGu = es("qi,ij,qj->q", u_q, G, u_q)
        tau = 1.0 / torch.sqrt(uGu + C_I * nu * nu * GdG)
        nu_lsic = 1.0 / (trG * tau)

        adv = es("qij,qj->qi", grad_u, u_q)          # (u.grad)u
        if transposed_stab:
            res_m = es("qij,qi->qj", grad_u, u_q) + grad_p
        else:
            res_m = adv + grad_p

        r_u = es("q,qi,qa->ai", wq, adv, phi)
        r_u = r_u + nu * es("q,qij,qaj->ai", wq, grad_u, g)
        r_u = r_u - es("q,q,qai->ai", wq, p_q, g)
        r_p = es("q,q,qa->a", wq, div_u, phi)

        res_dot_g = es("qj,qaj->qa", res_m, g)       # res_M . grad(phi_a)
        if transposed_stab:
            r_u = r_u + es("q,q,qi,qa->ai", wq, tau, u_q, res_dot_g)
        else:
            u_dot_g = es("qj,qaj->qa", u_q, g)
            r_u = r_u + es("q,q,qi,qa->ai", wq, tau, res_m, u_dot_g)
        r_p = r_p + es("q,qa->a", wq * tau, res_dot_g)
        r_u = r_u + es("q,q,qai->ai", wq * nu_lsic, div_u, g)

        r = torch.cat([r_u, r_p[:, None]], dim=1).reshape(-1)
        return r * detJ

    def jac_kernel(params, coords, w):
        """Hand-derived element tangent dr/dw (== jacfwd(kernel) to
        roundoff): per-qp state (u, Gu = du_i/dx_j, p, gp) with
        tau' = dtau/du = -tau^3 Gm u and nu_lsic' = tau Gm u / tr(Gm)."""
        nu, C_I = param_tensors(params, w)
        phi, dphi, wq = _tables(w)
        coords = coords.to(w.dtype)

        _, invJ, detJ = affine_geometry(coords, dim)
        Gm = es("ki,kj->ij", invJ, invJ)
        trG = Gm[0, 0] + Gm[1, 1] + Gm[2, 2]
        GdG = (Gm * Gm).sum()
        g = es("qak,ki->qai", dphi, invJ)
        eye = torch.eye(dim, dtype=w.dtype, device=w.device)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]
        u = es("qa,ai->qi", phi, u_n)
        Gu = es("qaj,ai->qij", g, u_n)
        gp = es("qai,a->qi", g, p_n)
        div = es("qii->q", Gu)

        Gmu = es("ij,qj->qi", Gm, u)
        uGu = es("qi,qi->q", u, Gmu)
        tau = 1.0 / torch.sqrt(uGu + C_I * nu * nu * GdG)
        nu_l = 1.0 / (trG * tau)
        t = -(tau ** 3)[:, None] * Gmu               # dtau/du_k
        n_ = (tau[:, None] * Gmu) / trG              # dnu_lsic/du_k

        if transposed_stab:
            res = es("qij,qi->qj", Gu, u) + gp
        else:
            res = es("qij,qj->qi", Gu, u) + gp

        gg = es("qak,qbk->qab", g, g)
        U = es("qk,qak->qa", u, g)                   # u . grad(phi_a)
        R = es("qk,qak->qa", res, g)                 # res . grad(phi_a)

        D_ab = es("q,qa,qb->ab", wq, phi, U)
        D_ab = D_ab + nu * es("q,qab->ab", wq, gg)
        J_uu = es("q,qa,qb,qij->aibj", wq, phi, phi, Gu)
        J_uu = J_uu + es("q,q,qai,qb,qj->aibj", wq, div, g, phi, n_)
        J_uu = J_uu + es("q,q,qai,qbj->aibj", wq, nu_l, g, g)
        if transposed_stab:
            W = es("qjk,qak->qaj", Gu, g)            # (Gu g_a)_j
            D_ab = D_ab + es("q,q,qa,qb->ab", wq, tau, R, phi)
            J_uu = J_uu + es("q,qi,qa,qb,qj->aibj", wq, u, R, phi, t)
            J_uu = J_uu + es("q,q,qi,qj,qab->aibj", wq, tau, u, u, gg)
            J_uu = J_uu + es("q,q,qi,qb,qaj->aibj", wq, tau, u, phi, W)
            J_up = es("q,q,qi,qab->aib", wq, tau, u, gg)
            J_pu = (es("q,qa,qb,qj->abj", wq, R, phi, t)
                    + es("q,q,qj,qab->abj", wq, tau, u, gg)
                    + es("q,q,qb,qaj->abj", wq, tau, phi, W))
        else:
            Wt = es("qkj,qak->qaj", Gu, g)           # (Gu^T g_a)_j
            Ub = es("qk,qbk->qb", u, g)              # u . grad(phi_b)
            J_uu = J_uu + es("q,qi,qa,qb,qj->aibj", wq, res, U, phi, t)
            J_uu = J_uu + es("q,q,qa,qb,ij->aibj", wq, tau, U, Ub, eye)
            J_uu = J_uu + es("q,q,qij,qa,qb->aibj", wq, tau, Gu, U, phi)
            J_uu = J_uu + es("q,q,qi,qaj,qb->aibj", wq, tau, res, g, phi)
            J_up = es("q,q,qbi,qa->aib", wq, tau, g, U)
            J_pu = (es("q,qa,qb,qj->abj", wq, R, phi, t)
                    + es("q,q,qb,qaj->abj", wq, tau, Ub, g)
                    + es("q,q,qb,qaj->abj", wq, tau, phi, Wt))
        J_uu = J_uu + es("ab,ij->aibj", D_ab, eye)
        J_up = J_up - es("q,qb,qai->aib", wq, phi, g)
        J_pu = J_pu + es("q,qa,qbj->abj", wq, phi, g)
        J_pp = es("q,q,qab->ab", wq, tau, gg)
        return detJ * _assemble_blocks(J_uu, J_up, J_pu, J_pp, nv, dim, bs)

    return kernel, jac_kernel


def make_ns_ugn_kernel(cell: str, nu, qdeg: int = 2) -> ElementKernel:
    """UGN/Tezduyar-tau stabilized NS kernel (lid-driven variant); nu is
    a runtime parameter.  On tetrahedra the cell-minor SoA variants
    (``forms/soa.py::make_ugn_soa``) ride along for the structured
    assembly."""
    soa = None
    if cell == "tetrahedron":
        from .soa import make_ugn_soa

        soa = make_ugn_soa(cell, qdeg)
    return ElementKernel(*_ugn_fns(cell, qdeg), (nu,), soa=soa)


@functools.lru_cache(maxsize=None)
def _ugn_fns(cell: str, qdeg: int):
    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    dim = elem.dim
    nv = elem.ndof
    bs = dim + 1
    es = torch.einsum

    def _tables(w):
        dtype, dev = w.dtype, w.device
        return (torch.as_tensor(phi_np, dtype=dtype, device=dev),
                torch.as_tensor(dphi_np, dtype=dtype, device=dev),
                torch.as_tensor(qr.weights, dtype=dtype, device=dev))

    def kernel(params, coords, w):
        (nu,) = param_tensors(params, w)
        phi, dphi, wq = _tables(w)
        coords = coords.to(w.dtype)

        _, invJ, detJ = affine_geometry(coords, dim)
        h = cell_diameter(coords)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]

        g = es("qak,ki->qai", dphi, invJ)
        u_q = es("qa,ai->qi", phi, u_n)
        grad_u = es("qaj,ai->qij", g, u_n)
        grad_p = es("qai,a->qi", g, p_n)
        div_u = es("qii->q", grad_u)
        p_q = es("qa,a->q", phi, p_n)

        u_sq = (u_q * u_q).sum(1)
        # |u| with a derivative-safe floor (a bare sqrt has a NaN
        # derivative at u = 0, which all-wall cells of coarse meshes
        # reach); finfo.tiny keeps the floor representable in f32
        u_norm = torch.sqrt(u_sq + torch.finfo(w.dtype).tiny)
        # tau_1 = h/(2|u|) with the reference's guard at |u| <= 1e-8
        inv_tau1_sq = torch.where(u_norm <= 1e-8, 0.0, 4.0 * u_sq / (h * h))
        tau3 = h * h / (4.0 * nu)
        tau_supg = 1.0 / torch.sqrt(inv_tau1_sq + 1.0 / tau3 ** 2)
        re_ugn = u_norm * h / (2.0 * nu)
        z = torch.clamp(re_ugn / 3.0, max=1.0)
        tau_lsic = 0.5 * h * u_norm * z

        adv = es("qij,qj->qi", grad_u, u_q)
        res = adv + grad_p                       # P1: viscous term vanishes

        r_u = es("q,qi,qa->ai", wq, adv, phi)
        r_u = r_u + nu * es("q,qij,qaj->ai", wq, grad_u, g)
        r_u = r_u - es("q,q,qai->ai", wq, p_q, g)
        r_p = es("q,q,qa->a", wq, div_u, phi)

        u_dot_g = es("qj,qaj->qa", u_q, g)       # u . grad(phi_a)
        r_u = r_u + es("q,qi,qa->ai", wq * tau_supg, res, u_dot_g)
        res_dot_g = es("qi,qai->qa", res, g)
        r_p = r_p + es("q,qa->a", wq * tau_supg, res_dot_g)
        r_u = r_u + es("q,q,qai->ai", wq * tau_lsic, div_u, g)

        r = torch.cat([r_u, r_p[:, None]], dim=1).reshape(-1)
        return r * detJ

    def jac_kernel(params, coords, w):
        """Hand-derived UGN tangent (== jacfwd(kernel) to roundoff):
        tau' chains through the |u| guard and the z = min(Re_UGN/3, 1)
        branch exactly as autodiff would."""
        (nu,) = param_tensors(params, w)
        phi, dphi, wq = _tables(w)
        coords = coords.to(w.dtype)

        _, invJ, detJ = affine_geometry(coords, dim)
        h = cell_diameter(coords)
        g = es("qak,ki->qai", dphi, invJ)
        eye = torch.eye(dim, dtype=w.dtype, device=w.device)
        tau3 = h * h / (4.0 * nu)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]
        u = es("qa,ai->qi", phi, u_n)
        Gu = es("qaj,ai->qij", g, u_n)
        gp = es("qai,a->qi", g, p_n)
        div = es("qii->q", Gu)

        u_sq = (u * u).sum(1)
        u_norm = torch.sqrt(u_sq + torch.finfo(w.dtype).tiny)
        guard = u_norm <= 1e-8
        inv_tau1_sq = torch.where(guard, 0.0, 4.0 * u_sq / (h * h))
        tau_s = 1.0 / torch.sqrt(inv_tau1_sq + 1.0 / tau3 ** 2)
        re_ugn = u_norm * h / (2.0 * nu)
        z = torch.clamp(re_ugn / 3.0, max=1.0)
        tau_l = 0.5 * h * u_norm * z
        # dtau_supg/du_k and dtau_lsic/du_k
        ts = torch.where(guard, 0.0,
                         -4.0 * tau_s ** 3 / (h * h))[:, None] * u
        dz = torch.where(re_ugn / 3.0 < 1.0, h / (6.0 * nu * u_norm), 0.0)
        tl = (0.5 * h * (z / u_norm + u_norm * dz))[:, None] * u

        res = es("qij,qj->qi", Gu, u) + gp
        gg = es("qak,qbk->qab", g, g)
        U = es("qk,qak->qa", u, g)
        R = es("qk,qak->qa", res, g)
        Wt = es("qkj,qak->qaj", Gu, g)

        D_ab = es("q,qa,qb->ab", wq, phi, U)
        D_ab = D_ab + nu * es("q,qab->ab", wq, gg)
        J_uu = es("q,qa,qb,qij->aibj", wq, phi, phi, Gu)
        J_uu = J_uu + es("q,q,qai,qb,qj->aibj", wq, div, g, phi, tl)
        J_uu = J_uu + es("q,q,qai,qbj->aibj", wq, tau_l, g, g)
        J_uu = J_uu + es("q,qi,qa,qb,qj->aibj", wq, res, U, phi, ts)
        J_uu = J_uu + es("q,q,qa,qb,ij->aibj", wq, tau_s, U, U, eye)
        J_uu = J_uu + es("q,q,qij,qa,qb->aibj", wq, tau_s, Gu, U, phi)
        J_uu = J_uu + es("q,q,qi,qaj,qb->aibj", wq, tau_s, res, g, phi)
        J_uu = J_uu + es("ab,ij->aibj", D_ab, eye)
        J_up = (es("q,q,qbi,qa->aib", wq, tau_s, g, U)
                - es("q,qb,qai->aib", wq, phi, g))
        J_pu = (es("q,qa,qbj->abj", wq, phi, g)
                + es("q,qa,qb,qj->abj", wq, R, phi, ts)
                + es("q,q,qb,qaj->abj", wq, tau_s, U, g)
                + es("q,q,qb,qaj->abj", wq, tau_s, phi, Wt))
        J_pp = es("q,q,qab->ab", wq, tau_s, gg)
        return detJ * _assemble_blocks(J_uu, J_up, J_pu, J_pp, nv, dim, bs)

    return kernel, jac_kernel
