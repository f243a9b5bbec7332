"""Outlet-image post-processing (host)."""
