"""Element tables, function spaces, boundary conditions (host)."""

from .bc import DirichletBC, combine_bcs
from .space import FunctionSpace, MixedVelocityPressureSpace
