"""Element kernels: stabilized Stokes and SUPS/LSIC Navier-Stokes."""
