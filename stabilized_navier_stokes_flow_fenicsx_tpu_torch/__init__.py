"""PyTorch/CUDA port of the stabilized finite-element Navier-Stokes solver.

The JAX package ``stabilized_navier_stokes_flow_fenicsx_tpu`` is the
reference; this package keeps its subpackage and module names so each
counterpart is easy to find, and its public array layouts (layered values
``(bs, bs, 3, E, Lp)``, plane-major dof vectors, row-sorted ``(E,)`` pair
lists) so the two can be compared like with like.

Layers (bottom-up):

- ``mesh``      image->contour pipeline, native 2D/3D meshers (host numpy)
- ``fem``       element tables, mixed space, boundary conditions (host)
- ``forms``     element kernels (stabilized Stokes, SUPS/LSIC Navier-Stokes)
- ``assemble``  structured/layered assembly and the layered SpMV kernel
- ``solve``     FGMRES, aggregation multigrid, Newton, layered drivers
- ``flow``      inlet profiles and the image-channel continuation solve
- ``io``        XDMF output and run manifests
- ``apps``      CLI entry points with the reference's argv contracts
"""

__version__ = "0.1.0"

import torch as _torch

# The dense coarse-grid inverse and its Newton-Schulz polish
# (solve/mg.py) need full float32 products: TF32 keeps ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import config as config  # noqa: E402
