"""1D Poisson: -u'' = f on (0,1), u(0)=u(1)=0  (FE_Practice notebook 1).

The reference keeps four pedagogy notebooks (FE_Practice/*.ipynb,
SURVEY.md 2.1); these scripts are their native equivalents built on the
framework's own element/assembly stack.

PyTorch twin of ``examples/poisson_1d.py``: runs on the card;
``main(device="cpu")`` runs it on the CPU.  From the repository root:

    PYTHONPATH=. python3 examples/torch_poisson_1d.py [u.npy]

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
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (
    solve_spd_cg)


def _t(a, like):
    """A host table as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def make_kernel(f=lambda x: np.pi**2 * np.sin(np.pi * x)):
    elem = element("interval", 1)
    qr = quadrature("interval", 3)
    phi, dphi = elem.tabulate(qr.points)

    def kernel(coords, w):
        h = coords[1, 0] - coords[0, 0]
        xq = coords[0, 0] + _t(qr.points[:, 0], w) * h
        g = _t(dphi[:, :, 0], w) / h          # (nq, 2)
        du = g @ w
        wq = _t(qr.weights, w) * h
        stiff = torch.einsum("q,q,qa->a", wq, du, g)
        load = torch.einsum("q,q,qa->a", wq,
                            np.pi**2 * torch.sin(np.pi * xq), _t(phi, w))
        return stiff - load

    return kernel


def main(n=64, device=None):
    mesh = unit_interval(n)
    fs = make_space(mesh, 1)
    asm = assembler_for_space(fs, device=device)
    bc = DirichletBC(np.array([0, n]), np.zeros(2))
    mask = asm.vector(bc_mask(fs.ndofs, bc))
    g = asm.vector(bc_vector(fs.ndofs, bc))
    res = solve_spd_cg(make_kernel(), fs.ndofs, 1e-12, asm.arrays, mask, g)
    u = res.x.cpu().numpy()
    x = mesh.points[:, 0]
    err = np.abs(u - np.sin(np.pi * x)).max()
    print(f"n={n}: max error vs sin(pi x) = {err:.2e}")
    return u


if __name__ == "__main__":
    import sys

    u = main()
    if len(sys.argv) > 1:
        np.save(sys.argv[1], u)
