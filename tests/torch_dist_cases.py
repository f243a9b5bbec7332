"""Multi-rank cases of the port's ``parallel/`` layer, and their launcher.

``run_ranks`` starts one process per rank (the port's
``parallel/launch.py::spawn_ranks``), which rendezvous over a file under
the given directory (gloo, CPU tensors) and run one of the ``CASES``
below; inputs and results travel as ``.npz`` files there.  A rank that
has not finished by the deadline is killed and the call raises, so a hung
rank cannot hold up a test run.

This module imports nothing of JAX: ``spawn`` re-imports the module of its
target in every rank.  The problems are built with the port's own modules
from the same parameters the JAX tests use, in every rank anew (host
numpy, deterministic).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

GROUP_TIMEOUT_S = 120.0


# ---- problems --------------------------------------------------------------


def duct_problem(n_cross=6, n_axial=13, Re=20.0, length=2.0):
    """The square-duct SUPS problem of tests/test_layered_shard.py:
    (mesh, W, mask, g, kernel), mask and g float64 host arrays."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.duct_stokes import (
        duct_bcs)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (
        bc_mask, bc_vector)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (
        duct_mesh)

    mesh = duct_mesh(n_cross, n_axial, length=length)
    W = make_mixed_space(mesh, 1, 1)
    bc = duct_bcs(mesh, W)
    mask = bc_mask(W.ndofs, bc).astype(np.float64)
    g = bc_vector(W.ndofs, bc)
    return mesh, W, mask, g, make_ns_sups_kernel("tetrahedron", 1.0 / Re)


def channel_problem(img, lc=0.2, Re=10.0, ratio=0.5):
    """The image-derived channel of tests/test_layered_shard.py's
    ``_channel_layered`` (splitter geometry, unused-node identity rows,
    inlet-profile BCs), as the port's dry run builds it: (mesh, W, mask,
    g, kernel)."""
    from __graft_entry_torch__ import _channel_problem

    return _channel_problem(img, lc, Re, ratio)


def cavity_problem(n=12, Re=50.0):
    """The lid-driven cavity of tests/test_sharding.py: (asm on the CPU,
    mask, g, UGN kernel)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.lid_driven import (
        cavity_bcs)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (
        assembler_for_mixed)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (
        bc_mask, bc_vector)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_ugn_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (
        unit_square_tri)

    mesh = unit_square_tri(n, n)
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, device="cpu")
    bc = cavity_bcs(mesh, W)
    return (asm, bc_mask(W.ndofs, bc).astype(np.float64),
            bc_vector(W.ndofs, bc), make_ns_ugn_kernel("triangle", 1.0 / Re))


def layered_problem(p: dict):
    """The problem a case's parameters name: ``geometry`` "duct" (with
    ``n_cross``, ``n_axial``, ``Re``) or "channel" (``img``, ``lc``,
    ``Re``)."""
    if p["geometry"] == "duct":
        return duct_problem(p.get("n_cross", 6), p.get("n_axial", 13),
                            p.get("Re", 20.0))
    return channel_problem(p["img"], p.get("lc", 0.2), p.get("Re", 10.0))


def padded_pattern(mesh, W, mask, g, D: int):
    """(lp, mask_p, g_p): the layered pattern with the planes padded to a
    multiple of D, host tables, and the BC vectors over the padding."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        build_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.layered_shard import (
        pad_mask_g, padded_planes)

    n2d, Lp, _ = mesh.layered
    lp = build_layered(W, n2d, padded_planes(Lp, D), device="cpu")
    mask_p, g_p = pad_mask_g(mask, g, lp.ndofs)
    return lp, mask_p, g_p


# ---- cases: what every rank runs -------------------------------------------


def case_layered_newton(p, arrays, group):
    """``sharded_newton_layered`` from g (or ``arrays['w0']``); every rank
    returns the gathered solution."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import comm
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.layered_shard import (
        gather_dofs, sharded_newton_layered)

    D = comm.world_size(group)
    mesh, W, mask, g, kern = layered_problem(p)
    lp, mask_p, g_p = padded_pattern(mesh, W, mask, g, D)
    w0 = g_p
    if "w0" in arrays:
        w0 = np.concatenate([arrays["w0"],
                             np.zeros(lp.ndofs - len(arrays["w0"]))])
    out = sharded_newton_layered(
        kern, lp, mask_p, g_p, w0, group, device="cpu", pc=p["pc"],
        mg_levels=p.get("mg_levels", 3), **p.get("tols", {}))
    return dict(x=gather_dofs(out.x, group).numpy(), iters=out.iters,
                converged=out.converged, resnorm=out.resnorm,
                history=out.history, n_local=out.x.numel(), ndofs=W.ndofs)


def case_slab_assembly(p, arrays, group):
    """``residual_fn`` and ``values_fn`` at ``arrays['w']``, and the slab
    SpMV (masked) of ``arrays['x']`` on those values: this rank's planes
    of each."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import comm
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.layered_shard import (
        SlabOperand, halo_extend, make_slab_assembly, shard_layered_inputs)

    D = comm.world_size(group)
    mesh, W, mask, g, kern = layered_problem(p)
    lp, mask_p, g_p = padded_pattern(mesh, W, mask, g, D)
    pad = np.zeros(lp.ndofs - W.ndofs)
    w = np.concatenate([arrays["w"], pad])
    arr, slab, meta, (mask_s, x_s, w_s) = shard_layered_inputs(
        lp, mask_p, np.concatenate([arrays["x"], pad]), w, group, "cpu")
    residual_fn, values_fn = make_slab_assembly(
        kern, lp.n2d, meta["Lq"], lp.bs, lp.E, group)
    r = residual_fn(slab, w_s)
    V = values_fn(slab, w_s)
    nb = lp.n2d * lp.bs
    op = SlabOperand(V, arr.cols, arr.row_ptr, lp.n2d,
                     halo_extend(mask_s, nb, group), group)
    y = op(x_s)
    return dict(r=r.numpy(), V=V.numpy(), y=y.numpy(),
                counts=meta["counts"], ncs=meta["ncs"],
                n_cells_local=slab.cell_dofs.shape[0])


def case_sharded_bcsr(p, arrays, group):
    """``sharded_newton`` (element-sharded) and ``spmd_newton_bcsr``
    (row-partitioned) on the cavity from ``arrays['w0']``."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import comm
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.shard import (
        make_sharded_problem, sharded_newton, spmd_newton_bcsr)

    asm, mask, g, kern = cavity_problem(p.get("n", 12), p.get("Re", 50.0))
    prob = make_sharded_problem(asm, group, device="cpu")
    out = sharded_newton(prob, kern, mask, g, arrays["w0"])
    out2 = spmd_newton_bcsr(asm, kern, mask, g, arrays["w0"], group,
                            device="cpu")
    return dict(x=out.x.numpy(), converged=out.converged, iters=out.iters,
                x2=comm.all_gather_cat(out2.x, group).numpy(),
                converged2=out2.converged, iters2=out2.iters,
                n_local2=out2.x.numel(),
                n_cells_local=prob.arrays.cell_dofs.shape[0],
                nnz_local=prob.arrays.indices.shape[0])


def case_comm(p, arrays, group):
    """The comm layer alone: sum, the two one-plane exchanges, the
    all-gather and the reduce-scatter."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import comm

    D, r = comm.world_size(group), comm.rank(group)
    t = torch.arange(4, dtype=torch.float64) + 10.0 * r
    full = torch.arange(2 * D, dtype=torch.float64) * (r + 1)
    prev, nxt = comm.exchange_halo(t[:2], t[2:], group)
    return dict(
        total=comm.all_reduce_sum(t.clone(), group).numpy(),
        scalar=float(comm.all_reduce_sum(torch.tensor(float(r + 1)), group)),
        fetched=comm.fetch_next_plane(t[:2], group).numpy(),
        pushed=comm.push_top_plane(t[2:], group).numpy(),
        prev=prev.numpy(), nxt=nxt.numpy(),
        gathered=comm.all_gather_cat(t, group).numpy(),
        scattered=comm.reduce_scatter_sum(full, group).numpy())


CASES = dict(layered_newton=case_layered_newton,
             slab_assembly=case_slab_assembly,
             sharded_bcsr=case_sharded_bcsr, comm=case_comm)


# ---- the launcher ----------------------------------------------------------


def _case_main(rank: int, n_ranks: int, device, case: str,
               workdir: str) -> None:
    with np.load(os.path.join(workdir, "in.npz")) as f:
        params = json.loads(str(f["__params__"]))
        arrays = {k: f[k] for k in f.files if k != "__params__"}
    out = CASES[case](params, arrays, None)
    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)


def run_ranks(case: str, n_ranks: int, workdir, params=None, arrays=None,
              deadline_s: float = 240.0):
    """Run ``CASES[case]`` on ``n_ranks`` gloo ranks; returns each rank's
    result as a dict of arrays, by rank.  Raises if a rank fails or the
    deadline passes (the ranks are killed first)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.launch import (
        spawn_ranks)

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, "in.npz"),
             __params__=json.dumps(params or {}), **(arrays or {}))
    spawn_ranks(_case_main, n_ranks, (case, workdir), device="cpu",
                deadline_s=deadline_s, group_timeout_s=GROUP_TIMEOUT_S,
                workdir=workdir)
    results = []
    for r in range(n_ranks):
        with np.load(os.path.join(workdir, f"out_{r}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results
