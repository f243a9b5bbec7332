"""Host mesh pipeline: image contours, 2D triangulation, extrusion."""

from .core import SimplexMesh, boundary_facets, facets_of_cells
