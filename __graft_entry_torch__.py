"""Root entry points of the PyTorch port: single-device forward step +
multi-rank dry run (the torch twin of ``__graft_entry__.py``).

entry(device=None) returns the forward step of the main model — the
stabilized Navier-Stokes residual + Jacobian assembly and one
preconditioned operator application on a small duct mesh (the innermost
computation every Newton iteration runs) — with its example arguments on
``device`` (the card when None).

dryrun_multichip(n) starts n ranks on this host's CPU (gloo) and runs, on
tiny shapes: one element-sharded Newton step on the duct; the
plane-sharded layered solve on the lc=0.2 image channel with the V-cycle,
held against the single-process solve; and one row-partitioned Newton
step on that channel.

    python3 __graft_entry_torch__.py               # entry() on the card
                                                   # (fails without one),
                                                   # then dryrun_multichip(4)
    python3 __graft_entry_torch__.py --device cpu  # entry() on the CPU
"""

import os
import tempfile

import numpy as np

N_STEPS = 3          # Newton steps of the layered dry run
KSP_RTOL = 1e-6


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def _tiny_problem(n_cross=4, n_axial=6, Re=10.0, device="cpu"):
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.duct_stokes import (
        duct_bcs)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (
        assembler_for_mixed)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (
        bc_mask, bc_vector)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.mesh.structured import (
        duct_mesh)

    mesh = duct_mesh(n_cross, n_axial, length=2.0)
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, device=device)
    bc = duct_bcs(mesh, W)
    mask = bc_mask(W.ndofs, bc).astype(np.float64)
    g = bc_vector(W.ndofs, bc)
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / Re)
    return asm, kern, mask, g


def entry(device=None):
    """(fn, example_args): the main model's forward step on ``device``
    (the card when None)."""
    import torch

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (
        matrix_values_of, residual_of)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import (
        default_device)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.precond import (
        block_jacobi)

    device = default_device() if device is None else torch.device(device)
    asm, kern, mask_np, g_np = _tiny_problem(device=device)
    mask, g = asm.vector(mask_np), asm.vector(g_np)
    nnzb, bs, ndofs = asm.pattern.nnzb, asm.pattern.bs, asm.ndofs
    arrays = asm.arrays

    def forward_step(w):
        """Residual + Jacobian assembly + one preconditioned operator
        application — the body of a Newton iteration."""
        r = mask * residual_of(kern, ndofs, arrays, w) \
            + (1.0 - mask) * (w - g)
        values = matrix_values_of(kern, nnzb, bs, arrays, w)
        M = block_jacobi(values[arrays.diag_pos], mask)
        return torch.linalg.vector_norm(r), M(-r)

    return forward_step, (asm.vector(np.zeros(ndofs)),)


def dryrun_multichip(n_devices: int) -> None:
    """Run the sharded Newton paths on ``n_devices`` CPU ranks (gloo) of
    this host, on tiny shapes.  This matches the rank semantics of the
    reference's ``mpirun -n 6/8`` jobs (reference run_all_RE.sh:9)
    without as many cards.  Raises if a rank fails or a check misses."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.launch import (
        spawn_ranks)

    with tempfile.TemporaryDirectory() as work:
        img, ref = _single_process_reference(work)
        spawn_ranks(_dryrun_multichip_impl, n_devices, (img, ref),
                    device="cpu", deadline_s=900.0, workdir=work)


def _channel_problem(img, lc=0.2, Re=10.0, ratio=0.5):
    """The image channel (lc=0.2 here): splitter geometry, unused-node
    identity rows, inlet-profile BCs (the reference's production shape at
    a small size).  Returns (mesh, W, mask, g, kernel)."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.bc import (
        DirichletBC, bc_mask, bc_vector, combine_bcs)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.channel import (
        channel_bcs, generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.navier_stokes import (
        make_ns_sups_kernel)

    inlet1, inlet2 = solve_inlet_profiles(img, ratio, DEFAULT)
    msh, _, _ = generate_channel_mesh(img, lc, DEFAULT, layered=True)
    W = make_mixed_space(msh, 1, 1)
    _n2d, _Lp, used = msh.layered
    bs = W.block_size
    unused_nodes = np.nonzero(~used)[0].astype(np.int64)
    unused_dofs = (unused_nodes[:, None] * bs
                   + np.arange(bs)[None, :]).ravel()
    bc = combine_bcs(
        [DirichletBC(unused_dofs, np.zeros(len(unused_dofs))),
         channel_bcs(msh, W, inlet1, inlet2)])
    mask = bc_mask(W.ndofs, bc).astype(np.float64)
    g = bc_vector(W.ndofs, bc)
    return msh, W, mask, g, make_ns_sups_kernel("tetrahedron", nu=1.0 / Re)


def _single_process_reference(work: str):
    """The single-process layered solve the sharded one is held against:
    N_STEPS Newton steps with the mg_cheby V-cycle at a real inner
    tolerance.  Returns (image path, path of the stored solution)."""
    import torch

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        build_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (
        solve_newton_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.mg import (
        build_mg_hierarchy)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.testimg import (
        make_annulus_image)

    torch.set_num_threads(1)
    img = make_annulus_image(os.path.join(work, "circle.png"), "circle")
    msh, W, mask, g, kern = _channel_problem(img)
    n2d, Lp, _ = msh.layered
    lp1 = build_layered(W, n2d, Lp, device="cpu")
    hier = build_mg_hierarchy(lp1.rows2d, lp1.cols2d, lp1.n2d, lp1.n_planes,
                              mask.astype(np.float32), lp1.bs, n_levels=2,
                              device="cpu")
    g_t = torch.as_tensor(g)
    out1 = solve_newton_layered(
        kern, lp1.n2d, lp1.n_planes, lp1.bs, lp1.arrays,
        torch.as_tensor(mask), g_t, g_t, lp1.E, 0.0, 0.0, N_STEPS,
        KSP_RTOL, 30, 8, "mg_cheby", hier)
    _check(out1.iters >= N_STEPS, "the single-process solve stopped early")
    ref = os.path.join(work, "single_process.npy")
    np.save(ref, out1.x.numpy())
    return img, ref


def _dryrun_multichip_impl(rank: int, n_devices: int, device, img: str,
                           ref: str) -> None:
    """What every rank runs (inside an initialised process group)."""
    import torch

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.shard import (
        make_sharded_problem, sharded_newton)

    asm, kern, mask, g = _tiny_problem()
    prob = make_sharded_problem(asm, device=device)
    out = sharded_newton(
        prob, kern, mask, g, np.zeros(asm.ndofs),
        rtol=1e-2, atol=1e-2, max_it=1, ksp_rtol=1e-2,
        ksp_restart=20, ksp_max_restarts=2)
    _check(np.isfinite(out.resnorm) and out.iters >= 1
           and bool(torch.isfinite(out.x).all()),
           "the element-sharded Newton step failed")

    _dryrun_layered_sharded(n_devices, device, img, ref)


def _dryrun_layered_sharded(n_devices: int, device, img: str,
                            ref: str) -> None:
    """Plane-sharded layered path at the production shape: the
    image-derived channel mesh, Newton + the V-cycle with level 0
    sharded, asserted against the single-process solve; then one
    row-partitioned Newton step on the same channel."""
    import torch

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (
        assembler_for_mixed)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (
        build_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import comm
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.layered_shard import (
        gather_dofs, pad_mask_g, padded_planes, sharded_newton_layered)
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.shard import (
        spmd_newton_bcsr)

    msh, W, mask, g, kern = _channel_problem(img)
    n2d, Lp, _ = msh.layered

    # n-rank plane-sharded solve on the plane-padded problem: the same
    # N_STEPS Newton iteration as the single-process reference
    Lp_pad = padded_planes(Lp, n_devices)
    lp = build_layered(W, n2d, Lp_pad, device="cpu")
    mask_p, g_p = pad_mask_g(mask, g, lp.ndofs)
    out = sharded_newton_layered(
        kern, lp, mask_p, g_p, g_p, device=device, pc="mg", mg_levels=2,
        rtol=0.0, atol=0.0, max_it=N_STEPS, ksp_rtol=KSP_RTOL,
        ksp_restart=30, ksp_max_restarts=8)
    _check(np.isfinite(out.resnorm) and out.iters >= N_STEPS,
           "the plane-sharded solve stopped early")
    _check(out.x.numel() == lp.ndofs // n_devices,
           "a rank's x is not its slab")
    x1 = np.load(ref)
    xs = gather_dofs(out.x).cpu().numpy()[:W.ndofs]
    rel = np.linalg.norm(xs - x1) / np.linalg.norm(x1)
    _check(rel < 1e-5, f"sharded channel Newton ({N_STEPS} steps) diverges "
                       f"from the single-process solve: {rel}")

    # row-partitioned dof vectors (parallel/shard.py::spmd_newton_bcsr)
    # at the channel shape: the unstructured path's scaling axis
    asm_c = assembler_for_mixed(W, device="cpu")
    out2 = spmd_newton_bcsr(
        asm_c, kern, mask, g, np.zeros(W.ndofs), device=device,
        rtol=1e-2, atol=1e-2, max_it=1, ksp_rtol=1e-2,
        ksp_restart=20, ksp_max_restarts=2)
    _check(np.isfinite(out2.resnorm) and out2.iters >= 1,
           "the row-partitioned Newton step failed")
    lengths = comm.all_gather_cat(
        torch.tensor([out2.x.numel()], device=out2.x.device))
    _check(len(set(lengths.tolist())) == 1,
           f"shard lengths differ: {lengths.tolist()}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where entry() runs: the card when omitted "
                         "(an error without one), or cpu")
    fn, args = entry(device=ap.parse_args().device)
    out = fn(*args)
    print(f"entry ok on {args[0].device}:",
          [float(np.asarray(o.cpu()).ravel()[0]) for o in out])
    dryrun_multichip(4)
    print("dryrun_multichip ok")
