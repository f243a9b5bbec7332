"""Preconditioners for the block-CSR and layered operators.

Counterparts of the JAX package's ``solve/precond.py``, with its names,
signatures and the layered value layout (bs, bs, 3, E, Lp) with
plane-major vectors.

* ``block_jacobi``: with the equal-order P1-P1 layout every mesh node
  carries a (dim+1)x(dim+1) diagonal block coupling its velocity
  components and pressure; inverting all of them is one batched 4x4
  inverse.  Constrained (Dirichlet) rows/cols are projected to identity
  so the preconditioner matches the BC-projected operator.
* The layered family relaxes the extrusion structure: vertical lines
  (``line_jacobi_layered``, a blocked Thomas solve looping over planes;
  ``line_cr_layered``, the same solve by cyclic reduction, batched over
  planes) and planes (``plane_gs_layered``, Gauss-Seidel over planes;
  ``plane_zebra_layered``, red-black planes; ``plane_gs_grouped``, groups
  of planes).  ``segment_sum`` is ``index_add_`` here and the JAX
  einsums take explicit batch dimensions.

``plane_gs_layered`` runs through kernel K2 on a CUDA tensor
(solve/plane_gs.py; the plain PyTorch version on a CPU tensor); the
others are PyTorch ops on either device.  Precision with ``pc_dtype``
(bf16): the zebra, grouped and line solves store their factors and
values in it and compute in it, as the JAX package does; the plane-GS
sweep stores its values and block inverses in it and computes in
float32 (see solve/plane_gs.py).  The 4x4 inverses are taken in float32
or wider.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def identity_pc() -> Callable:
    return lambda x: x


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (..., n, n) in A's dtype (taken in float32 when
    A is narrower)."""
    if A.dtype in (torch.float32, torch.float64):
        return torch.linalg.inv(A)
    return torch.linalg.inv(A.float()).to(A.dtype)


def _bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n, n) @ (..., n) -> (..., n)."""
    return (M @ v[..., None])[..., 0]


def block_jacobi(diag_blocks: torch.Tensor, mask: torch.Tensor) -> Callable:
    """M^{-1} from node-diagonal blocks.

    diag_blocks: (n_rows, bs, bs); mask: (n_rows*bs,) 1 on free dofs.
    Returns a closure x -> D^{-1} x with each block projected
    (P_b D_b P_b + I - P_b) before inversion; x is taken in the blocks'
    dtype and returned in its own.
    """
    n, bs, _ = diag_blocks.shape
    mb = mask.reshape(n, bs).to(diag_blocks.dtype)
    P = mb[:, :, None] * mb[:, None, :]
    eye = torch.eye(bs, dtype=diag_blocks.dtype, device=diag_blocks.device)
    Dproj = diag_blocks * P + (1.0 - mb)[:, :, None] * eye
    Dinv = torch.linalg.inv(Dproj)

    def apply(x):
        xb = x.reshape(n, 1, bs).to(Dinv.dtype)
        return (Dinv * xb).sum(dim=-1).reshape(-1).to(x.dtype)

    return apply


def projected_diag_inverse(values: torch.Tensor, diag_pos: torch.Tensor,
                           mb: torch.Tensor) -> torch.Tensor:
    """(Lp, n2d, bs, bs) inverses of the self-pair's in-plane blocks,
    each projected (P D P + I - P) by the (Lp, n2d, bs) mask ``mb``; in
    the promoted dtype of the values and the mask."""
    bs = values.shape[0]
    diag = values[:, :, 1, diag_pos, :].permute(3, 2, 0, 1)
    P = mb[..., :, None] * mb[..., None, :]
    eye = torch.eye(bs, dtype=values.dtype, device=values.device)
    return _inv(diag * P + (1.0 - mb)[..., None] * eye)


def _vertical_line_blocks(values, diag_pos, mask, n2d, n_planes):
    """(A, B, C) block-tridiagonal coefficients of every 2D node's
    extrusion column (the self-pair's delta = -1/0/+1 blocks), each
    (Lp, n2d, bs, bs), with constrained rows/cols projected to identity
    so the line solve matches the BC-projected operator."""
    bs = values.shape[0]
    Lp = n_planes
    mb = mask.reshape(Lp, n2d, bs)
    eye = torch.eye(bs, dtype=values.dtype, device=values.device)
    sp = values[:, :, :, diag_pos, :]        # (bs, bs, 3, n2d, Lp)
    A = sp[:, :, 1].permute(3, 2, 0, 1)      # (Lp, n2d, bs, bs)
    B = sp[:, :, 0].permute(3, 2, 0, 1)      # x[l-1] coupling
    C = sp[:, :, 2].permute(3, 2, 0, 1)      # x[l+1] coupling
    Pl = mb[..., :, None] * mb[..., None, :]
    A = A * Pl + (1.0 - mb)[..., None] * eye
    # off-diagonals: rows of constrained dofs and columns of constrained
    # neighbor dofs are zeroed
    mb_m = torch.cat([torch.zeros_like(mb[:1]), mb[:-1]], dim=0)
    mb_p = torch.cat([mb[1:], torch.zeros_like(mb[:1])], dim=0)
    B = B * (mb[..., :, None] * mb_m[..., None, :])
    C = C * (mb[..., :, None] * mb_p[..., None, :])
    return A, B, C


def line_jacobi_layered(
    values: torch.Tensor,         # (bs, bs, 3, E, Lp) layered matrix
    diag_pos: torch.Tensor,       # (n2d,) self-pair ids
    mask: torch.Tensor,           # (Lp*n2d*bs,)
    n2d: int,
    n_planes: int,
) -> Callable:
    """Vertical-line relaxation for extruded meshes.

    For each 2D node i, solve the block-tridiagonal system along its
    extrusion column (the self-pair's delta = -1/0/+1 blocks), the
    strongest coupling direction of channel meshes.  All n2d columns
    factor and solve together: a blocked Thomas algorithm as a loop over
    planes with (n2d, bs, bs) batched arithmetic.  Strictly stronger than
    node-block Jacobi (its delta=0-only limit).  ``line_cr_layered`` is
    the same solve at log depth.
    """
    bs = values.shape[0]
    Lp = n_planes
    A, B, C = _vertical_line_blocks(values, diag_pos, mask, n2d, n_planes)

    # blocked Thomas factorization: forward eliminate
    Dinv = []
    Dprev_inv = torch.eye(bs, dtype=A.dtype, device=A.device) \
        .expand(n2d, bs, bs)
    Cprev = torch.zeros_like(A[0])
    for l in range(Lp):
        Dl = _inv(A[l] - B[l] @ Dprev_inv @ Cprev)
        Dinv.append(Dl)
        Dprev_inv, Cprev = Dl, C[l]

    def apply(x):
        r = x.reshape(Lp, n2d, bs).to(A.dtype)
        Y, y = [], torch.zeros_like(r[0])
        for l in range(Lp):
            y = _bmv(Dinv[l], r[l] - _bmv(B[l], y))
            Y.append(y)
        X, xn = [None] * Lp, torch.zeros_like(r[0])
        for l in reversed(range(Lp)):
            xn = Y[l] - _bmv(Dinv[l], _bmv(C[l], xn))
            X[l] = xn
        return torch.stack(X).reshape(-1).to(x.dtype)

    return apply


def line_cr_layered(
    values: torch.Tensor,         # (bs, bs, 3, E, Lp) layered matrix
    diag_pos: torch.Tensor,       # (n2d,) self-pair ids
    mask: torch.Tensor,           # (Lp*n2d*bs,)
    n2d: int,
    n_planes: int,
    pc_dtype=None,
) -> Callable:
    """Vertical-line solve by block cyclic reduction, at log depth.

    Same system as ``line_jacobi_layered`` (every 2D node's extrusion
    column, block-tridiagonal over planes), eliminated by halving: each
    level removes the odd planes with batched (m/2*n2d, bs, bs) products,
    so the solve is ~2*log2(Lp) dependent steps instead of 2*Lp.

    The factorization (this function body) runs once per Jacobian; the
    returned closure does the rhs reduction and back-substitution.
    pc_dtype: cast the stored factors (the factorization stays in the
    values' dtype); the apply then runs in it.
    """
    bs = values.shape[0]
    Lp = n_planes
    A, B, C = _vertical_line_blocks(values, diag_pos, mask, n2d, n_planes)
    dt, dev = A.dtype, A.device
    # pad planes to a power of two with identity rows (decoupled: B=C=0)
    m = 1 << max(1, (Lp - 1).bit_length())
    if m > Lp:
        eye_pad = torch.eye(bs, dtype=dt, device=dev).expand(
            m - Lp, n2d, bs, bs)
        zero_pad = torch.zeros((m - Lp, n2d, bs, bs), dtype=dt, device=dev)
        A = torch.cat([A, eye_pad], dim=0)
        B = torch.cat([B, zero_pad], dim=0)
        C = torch.cat([C, zero_pad], dim=0)

    # per-level factors: (Ainv_odd, B_odd, C_odd, G, H) with
    #   G_j = B_{2j} Ainv_{2j-1},  H_j = C_{2j} Ainv_{2j+1}
    levels = []
    zero1 = torch.zeros((1, n2d, bs, bs), dtype=dt, device=dev)
    while m > 1:
        Ao, Bo, Co = A[1::2], B[1::2], C[1::2]      # odd planes (m/2)
        Ainv_o = _inv(Ao)
        Ae, Be, Ce = A[0::2], B[0::2], C[0::2]      # even planes (m/2)
        # shift: even plane 2j couples down to odd 2j-1 (level index j-1)
        Ainv_dn = torch.cat([zero1, Ainv_o[:-1]], dim=0)
        C_dn = torch.cat([zero1, Co[:-1]], dim=0)
        B_dn = torch.cat([zero1, Bo[:-1]], dim=0)
        G = Be @ Ainv_dn                             # zero at j=0 (B_0=0)
        H = Ce @ Ainv_o
        A = Ae - G @ C_dn - H @ Bo
        B = -(G @ B_dn)
        C = -(H @ Co)
        levels.append((Ainv_o, Bo, Co, G, H))
        m //= 2
    Ainv_root = _inv(A[0])                           # (n2d, bs, bs)

    if pc_dtype is not None:
        levels = [tuple(t.to(pc_dtype) for t in lv) for lv in levels]
        Ainv_root = Ainv_root.to(pc_dtype)
    work = Ainv_root.dtype
    Lp_pad = 1 << max(1, (Lp - 1).bit_length())

    def apply(r):
        out_dtype = r.dtype
        rl = r.to(work).reshape(Lp, n2d, bs)
        if Lp_pad > Lp:
            rl = torch.cat([rl, rl.new_zeros((Lp_pad - Lp, n2d, bs))], dim=0)
        # forward: reduce rhs level by level
        rhss = []
        for (_Ainv_o, _Bo, _Co, G, H) in levels:
            ro, re = rl[1::2], rl[0::2]
            rhss.append(rl)
            ro_dn = torch.cat([ro.new_zeros((1, n2d, bs)), ro[:-1]], dim=0)
            rl = re - _bmv(G, ro_dn) - _bmv(H, ro)
        x = _bmv(Ainv_root, rl[0])[None]
        # backward: recover odd planes
        for (Ainv_o, Bo, Co, _G, _H), rk in zip(reversed(levels),
                                                reversed(rhss)):
            ro = rk[1::2]
            x_up = torch.cat([x[1:], x.new_zeros((1, n2d, bs))], dim=0)
            xo = _bmv(Ainv_o, ro - _bmv(Bo, x) - _bmv(Co, x_up))
            x = torch.stack([x, xo], dim=1).reshape(rk.shape[0], n2d, bs)
        return x[:Lp].reshape(-1).to(out_dtype)

    return apply


def plane_gs_layered(
    values: torch.Tensor,         # (bs, bs, 3, E, Lp)
    cols: torch.Tensor,           # (E,)
    row_ids: torch.Tensor,        # (E,) sorted
    diag_pos: torch.Tensor,       # (n2d,)
    mask: torch.Tensor,
    n2d: int,
    n_planes: int,
    inner_sweeps: int = 2,
    symmetric: bool = True,
    pc_dtype=None,
    row_ptr: Optional[torch.Tensor] = None,
) -> Callable:
    """Plane-block Gauss-Seidel for the layered operator.

    Sweeps plane by plane downstream (and upstream when symmetric): each
    plane's 2D block system is relaxed with ``inner_sweeps`` Jacobi
    iterations on the plane-local 2D pairs, after a direct block-diagonal
    hit.  Downstream sweeping follows the channel's advection, which makes
    the lower-triangular part of the NS Jacobian dominant: the classic
    line/plane relaxation for convection-dominated flow.

    The sweep is kernel K2 on a CUDA tensor: the closure is a
    ``PlaneGSOperand`` (solve/plane_gs.py), built here once per values
    tensor.  ``row_ptr`` (n2d + 1,) is the row-sorted pair list's row
    pointer (derived from ``row_ids`` when None).  With ``pc_dtype`` the
    values and block inverses are stored in it and the sweep computes in
    float32.
    """
    from ..utils.device import row_ptr_of
    from .plane_gs import PlaneGSOperand

    if row_ptr is None:
        row_ptr = torch.as_tensor(row_ptr_of(row_ids.cpu().numpy(), n2d),
                                  device=row_ids.device)
    return PlaneGSOperand(values, cols, row_ptr, diag_pos, mask, n2d,
                          inner_sweeps=inner_sweeps, symmetric=symmetric,
                          dtype=pc_dtype)


def _spmv_planes(Vsub, xsub, cols, row_ids, n2d):
    """Plane-batched 2D SpMV: Vsub (bs, bs, E, L2), xsub (L2, n2d, bs) ->
    (L2, n2d, bs)."""
    xjT = xsub[:, cols, :].permute(2, 1, 0)          # (bs, E, L2)
    contrib = (Vsub * xjT[None]).sum(dim=1)          # (bs, E, L2)
    out = contrib.new_zeros((n2d, contrib.shape[0], contrib.shape[2]))
    out.index_add_(0, row_ids, contrib.permute(1, 0, 2))   # (n2d, bs, L2)
    return out.permute(2, 0, 1)


def plane_zebra_layered(
    values: torch.Tensor,         # (bs, bs, 3, E, Lp)
    cols: torch.Tensor,
    row_ids: torch.Tensor,
    diag_pos: torch.Tensor,
    mask: torch.Tensor,
    n2d: int,
    n_planes: int,
    inner_sweeps: int = 2,
    zebra_sweeps: int = 2,
    pc_dtype=None,
) -> Callable:
    """Zebra (red-black plane) relaxation: plane-GS strength class with
    no sequential sweep.

    The layered operator is block-tridiagonal over planes, so planes of
    one parity only couple to the other parity: relax all even planes
    jointly (batched over Lp/2 planes), then all odd planes with the
    fresh even values, and repeat.  Each half-sweep is the same plane
    relaxation plane-GS performs (``inner_sweeps`` damped Jacobi passes
    on the plane-local 2D system preceded by a direct block-diagonal
    hit), at dependency depth 2 per sweep instead of Lp.
    """
    bs, _, _, E, Lp = values.shape
    Lp_pad = Lp + (Lp % 2)
    mb = mask.reshape(Lp, n2d, bs)
    Dinv = projected_diag_inverse(values, diag_pos, mb)
    if Lp_pad > Lp:                          # a decoupled identity plane
        mb = torch.cat([mb, mb.new_zeros((1, n2d, bs))], dim=0)
        Dinv = torch.cat([Dinv, torch.eye(
            bs, dtype=Dinv.dtype, device=Dinv.device).expand(
                1, n2d, bs, bs)], dim=0)

    def padV(v):                             # (bs, bs, E, Lp) -> Lp_pad
        if Lp_pad == Lp:
            return v
        return torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)

    V0 = padV(values[:, :, 1])
    Vm = padV(values[:, :, 0])               # couples to x[l-1]
    Vp = padV(values[:, :, 2])               # couples to x[l+1]
    if pc_dtype is not None:
        V0, Vm, Vp = (v.to(pc_dtype) for v in (V0, Vm, Vp))
        Dinv = Dinv.to(pc_dtype)
        mb = mb.to(pc_dtype)
    else:
        Dinv = Dinv.to(values.dtype)
        mb = mb.to(values.dtype)
    H = Lp_pad // 2

    def spmv(Vsub, xsub):
        return _spmv_planes(Vsub, xsub, cols, row_ids, n2d)

    V0e, V0o = V0[..., 0::2], V0[..., 1::2]
    Vme, Vmo = Vm[..., 0::2], Vm[..., 1::2]
    Vpe, Vpo = Vp[..., 0::2], Vp[..., 1::2]
    De, Do = Dinv[0::2], Dinv[1::2]
    me, mo = mb[0::2], mb[1::2]

    def relax_color(Vc, Dc, mc, rhs, x0):
        x = x0
        for _ in range(inner_sweeps):
            res = (rhs - spmv(Vc, x * mc)) * mc + (1.0 - mc) * (rhs - x)
            x = x + _bmv(Dc, res)
        return x

    def apply(r):
        out_dtype = r.dtype
        rb = r.to(V0.dtype).reshape(Lp, n2d, bs)
        if Lp_pad > Lp:
            rb = torch.cat([rb, rb.new_zeros((1, n2d, bs))], dim=0)
        re, ro = rb[0::2], rb[1::2]
        zero_pl = rb.new_zeros((1, n2d, bs))
        xe = rb.new_zeros((H, n2d, bs))
        xo = rb.new_zeros((H, n2d, bs))
        for sweep in range(zebra_sweeps):
            # even planes 2j: lower neighbor = odd[j-1], upper = odd[j]
            xo_dn = torch.cat([zero_pl, xo[:-1]], dim=0)
            rhs = re - spmv(Vme, xo_dn) - spmv(Vpe, xo)
            rhs = me * rhs + (1.0 - me) * re
            x0e = _bmv(De, rhs) if sweep == 0 else xe
            xe = relax_color(V0e, De, me, rhs, x0e)
            # odd planes 2j+1: lower = even[j], upper = even[j+1]
            xe_up = torch.cat([xe[1:], zero_pl], dim=0)
            rhs = ro - spmv(Vmo, xe) - spmv(Vpo, xe_up)
            rhs = mo * rhs + (1.0 - mo) * ro
            x0o = _bmv(Do, rhs) if sweep == 0 else xo
            xo = relax_color(V0o, Do, mo, rhs, x0o)
        x = torch.stack([xe, xo], dim=1).reshape(Lp_pad, n2d, bs)
        return x[:Lp].reshape(-1).to(out_dtype)

    return apply


def plane_gs_grouped(
    values: torch.Tensor,         # (bs, bs, 3, E, Lp)
    cols: torch.Tensor,
    row_ids: torch.Tensor,
    diag_pos: torch.Tensor,
    mask: torch.Tensor,
    n2d: int,
    n_planes: int,
    group: int = 8,
    inner_sweeps: int = 2,
    symmetric: bool = True,
    pc_dtype=None,
) -> Callable:
    """Plane-GS with ``group`` planes relaxed jointly per step.

    The sweep moves in groups of G planes: Lp/G sequential steps, each
    relaxing all G planes of the group together (Jacobi within the
    group, Gauss-Seidel between groups, downstream then upstream).
    Convergence sits between plane-GS and plane-Jacobi.
    """
    bs, _, _, E, Lp = values.shape
    G = group
    Lp_pad = -(-Lp // G) * G
    padp = Lp_pad - Lp

    def padL(a):
        # pad the trailing plane axis with zeros
        if padp == 0:
            return a
        return torch.cat([a, a.new_zeros(a.shape[:-1] + (padp,))], dim=-1)

    mb = mask.reshape(Lp, n2d, bs)
    Dinv = projected_diag_inverse(values, diag_pos, mb)
    if padp:                                 # decoupled identity planes
        mb = torch.cat([mb, mb.new_zeros((padp, n2d, bs))], dim=0)
        Dinv = torch.cat([Dinv, torch.eye(
            bs, dtype=Dinv.dtype, device=Dinv.device).expand(
                padp, n2d, bs, bs)], dim=0)
    ng = Lp_pad // G

    # (ngroups, bs, bs, G, E)
    def grouped(vpart):
        v = padL(vpart)                           # (bs, bs, E, Lp_pad)
        v = v.reshape(bs, bs, E, ng, G)
        return v.permute(3, 0, 1, 4, 2)           # (ng, bs, bs, G, E)

    V0 = grouped(values[:, :, 1])
    Vm = grouped(values[:, :, 0])
    Vp = grouped(values[:, :, 2])
    work = pc_dtype or values.dtype
    V0, Vm, Vp = (v.to(work) for v in (V0, Vm, Vp))
    Dinv_g = Dinv.to(work).reshape(ng, G, n2d, bs, bs)
    mb_g = mb.to(work).reshape(ng, G, n2d, bs)

    def spmv_group(Vg, y):
        """Vg: (bs, bs, G, E); y: (G, n2d, bs) -> (G, n2d, bs)."""
        xj = y[:, cols, :].permute(2, 0, 1)       # (bs, G, E)
        contrib = (Vg * xj[None]).sum(dim=1)      # (bs, G, E)
        out = contrib.new_zeros((n2d, G, bs))
        out.index_add_(0, row_ids, contrib.permute(2, 1, 0))
        return out.permute(1, 0, 2)

    def relax_group(gi, rhs, below, above, y):
        """inner Jacobi sweeps on the G-plane block system."""
        V0g, Vmg, Vpg, Dg, mg = V0[gi], Vm[gi], Vp[gi], Dinv_g[gi], mb_g[gi]
        for _ in range(inner_sweeps + 1):
            y_dn = torch.cat([below[None], y[:-1]], dim=0)
            y_up = torch.cat([y[1:], above[None]], dim=0)
            Ay = (spmv_group(V0g, y * mg) + spmv_group(Vmg, y_dn)
                  + spmv_group(Vpg, y_up))
            res = (rhs - Ay) * mg + (1.0 - mg) * (rhs - y)
            y = y + _bmv(Dg, res)
        return y

    def apply(r):
        out_dtype = r.dtype
        rb = r.to(work).reshape(Lp, n2d, bs)
        if padp:
            rb = torch.cat([rb, rb.new_zeros((padp, n2d, bs))], dim=0)
        rb = rb.reshape(ng, G, n2d, bs)
        zero_pl = rb.new_zeros((n2d, bs))

        Xd, below = [], zero_pl
        for gi in range(ng):
            y = relax_group(gi, rb[gi], below, zero_pl,
                            _bmv(Dinv_g[gi], rb[gi]))
            Xd.append(y)
            below = y[-1]
        if not symmetric:
            X = torch.stack(Xd).reshape(Lp_pad, n2d, bs)[:Lp]
            return X.reshape(-1).to(out_dtype)

        Xu, above = [None] * ng, zero_pl
        for gi in reversed(range(ng)):
            below = Xd[gi - 1][-1] if gi > 0 else zero_pl
            y = relax_group(gi, rb[gi], below, above, Xd[gi])
            Xu[gi] = y
            above = y[0]
        X = torch.stack(Xu).reshape(Lp_pad, n2d, bs)[:Lp]
        return X.reshape(-1).to(out_dtype)

    return apply


def scalar_jacobi(diag: torch.Tensor, mask: torch.Tensor) -> Callable:
    """x -> x / d with d = diag on free dofs and 1 on constrained ones."""
    inv = 1.0 / (mask * diag + (1.0 - mask))

    def apply(x):
        return inv * x

    return apply
