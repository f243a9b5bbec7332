"""3D Laplace on a box (FE_Practice notebook 4): u = x exactly.

PyTorch twin of ``examples/laplace_3d.py``: runs on the card;
``main(device="cpu")`` runs it on the CPU.  From the repository root:

    PYTHONPATH=. python3 examples/torch_laplace_3d.py [u.npy]

(the optional path saves the field with ``np.save``).
"""

import numpy as np

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (
    assembler_for_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (
    DirichletBC, bc_mask, bc_vector, combine_bcs)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
    make_space)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.poisson import (
    make_poisson_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (
    box_tet)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (
    solve_spd_cg)


def main(n=8, device=None):
    mesh = box_tet((n, n, n), (0, 0, 0), (1, 1, 1))
    fs = make_space(mesh, 1)
    asm = assembler_for_space(fs, device=device)
    pts = mesh.points
    x0 = np.nonzero(np.abs(pts[:, 0]) < 1e-12)[0]
    x1 = np.nonzero(np.abs(pts[:, 0] - 1) < 1e-12)[0]
    bc = combine_bcs([
        DirichletBC(x0, np.zeros(len(x0))),
        DirichletBC(x1, np.ones(len(x1))),
    ])
    mask = asm.vector(bc_mask(fs.ndofs, bc))
    g = asm.vector(bc_vector(fs.ndofs, bc))
    kern = make_poisson_kernel("tetrahedron", 1, forcing=0.0)
    res = solve_spd_cg(kern, fs.ndofs, 1e-12, asm.arrays, mask, g)
    u = res.x.cpu().numpy()
    err = np.abs(u - pts[:, 0]).max()
    print(f"n={n}: max error vs u=x : {err:.2e}")
    return u


if __name__ == "__main__":
    import sys

    u = main()
    if len(sys.argv) > 1:
        np.save(sys.argv[1], u)
