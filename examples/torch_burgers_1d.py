"""Steady 1D viscous Burgers: u u' = nu u'' on (0,1), u(0)=1, u(1)=-1
(FE_Practice notebook 2 — Newton iteration on a nonlinear form).

PyTorch twin of ``examples/burgers_1d.py``: runs on the card;
``main(device="cpu")`` runs it on the CPU.  From the repository root:

    PYTHONPATH=. python3 examples/torch_burgers_1d.py [u.npy]

(the optional path saves the field with ``np.save``).
"""

import numpy as np
import torch

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (
    assembler_for_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (
    DirichletBC, bc_mask, bc_vector)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.elements import (
    element, quadrature)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
    make_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (
    unit_interval)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.newton_host import (
    newton_host_lu)


def _t(a, like):
    """A host table as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def make_kernel(nu=0.05):
    elem = element("interval", 1)
    qr = quadrature("interval", 3)
    phi_np, dphi_np = elem.tabulate(qr.points)

    def kernel(coords, w):
        h = coords[1, 0] - coords[0, 0]
        phi = _t(phi_np, w)
        g = _t(dphi_np[:, :, 0], w) / h
        wq = _t(qr.weights, w) * h
        uq = phi @ w
        du = g @ w
        adv = torch.einsum("q,q,q,qa->a", wq, uq, du, phi)
        visc = nu * torch.einsum("q,q,qa->a", wq, du, g)
        return adv + visc

    return kernel


def main(n=128, nu=0.05, device=None):
    mesh = unit_interval(n)
    fs = make_space(mesh, 1)
    asm = assembler_for_space(fs, device=device)
    bc = DirichletBC(np.array([0, n]), np.array([1.0, -1.0]))
    mask = asm.vector(bc_mask(fs.ndofs, bc))
    g = asm.vector(bc_vector(fs.ndofs, bc))
    x0 = 1.0 - 2.0 * mesh.points[:, 0]    # linear initial guess
    res = newton_host_lu(asm, make_kernel(nu), mask, g, x0, rtol=1e-12)
    u = res.x
    print(f"Newton iters: {res.iters}, converged: {res.converged}")
    # the solution is the tanh shock profile u = -tanh((x-1/2)/(2 nu)) * c
    mid = u[np.argmin(np.abs(mesh.points[:, 0] - 0.5))]
    print(f"u(0.5) = {mid:.3e} (expect ~0 by symmetry)")
    return u


if __name__ == "__main__":
    import sys

    u = main()
    if len(sys.argv) > 1:
        np.save(sys.argv[1], u)
