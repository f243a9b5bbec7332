"""Run output folders + RunParameters.txt manifests.

Replicates reference NavierStokes/NavierStokesChannelFlow.py:384-465:
noether_data/NSChannelFlow_RE{Re}_MeshLC{lc}_{img} folders, a
RunParameters.txt manifest (Re, image, ratio, lc, DOF counts, core count)
and a copy of the input image.
"""

from __future__ import annotations

import os
import shutil
from typing import Tuple


def make_output_folder(Re, img_fname: str, channel_mesh_size: float,
                       root: str = "noether_data") -> Tuple[str, str]:
    """Create the run folder; returns (folder_path, img_name)."""
    img_name = os.path.basename(img_fname)
    if img_name.endswith(".png"):
        img_name = img_name[:-4]
    lc_str = str(channel_mesh_size).replace(".", "")
    os.makedirs(root, exist_ok=True)
    folder = os.path.join(
        root, f"NSChannelFlow_RE{Re}_MeshLC{lc_str}_{img_name}")
    os.makedirs(folder, exist_ok=True)
    return folder, img_name


def write_run_metadata(
    folder: str,
    Re,
    img_fname: str,
    flowrate_ratio: float,
    channel_mesh_size: float,
    pressure_dofs: int,
    velocity_dofs: int,
    n_devices: int,
    img_name: str,
) -> None:
    with open(os.path.join(folder, "RunParameters.txt"), "w") as f:
        f.write(f"Re={Re}\n")
        f.write(f"img_filename={img_fname}\n")
        f.write(f"Flowrate Ratio={flowrate_ratio}\n")
        f.write(f"Channel Mesh Size={channel_mesh_size}\n")
        f.write(f"Pressure DOFs: {pressure_dofs}\n")
        f.write(f"Velocity DOFs: {velocity_dofs}\n")
        f.write(f"{n_devices} Devices Used\n")
    try:
        shutil.copyfile(img_fname, os.path.join(folder, f"{img_name}.png"))
    except OSError:
        pass
