"""Small shared utilities."""

from .linalg import det_small, inv_small, solve_dense_qr
