"""XDMF output and run manifests."""

from .metadata import make_output_folder, write_run_metadata
from .xdmf import write_xdmf_function
