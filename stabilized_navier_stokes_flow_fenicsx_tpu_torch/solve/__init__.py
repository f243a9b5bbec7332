"""Krylov, multigrid, Newton and the layered solve drivers."""
