"""The port's element-sharded block-CSR path (parallel/shard.py) and its
comm layer on several gloo ranks, against the JAX package and the port's
single-process solve.  Float64 on the CPU; the rank processes run
tests/torch_dist_cases.py.

* the comm layer: sum, the two one-plane neighbour exchanges, all-gather
  and reduce-scatter on 1 to 4 ranks, exact;
* ``spmd_pad_problem``: tables and padded sizes ``np.array_equal`` to the
  JAX package's for 2, 4 and 8 ranks;
* ``make_sharded_problem``: every rank holds 1/D of the padded cells and
  nonzero blocks;
* ``sharded_newton`` (element-sharded, whole dof vectors) and
  ``spmd_newton_bcsr`` (row-partitioned dof vectors) on the lid-driven
  cavity, 2 and 4 ranks: relative error < 1e-8 against the port's
  single-process ``solve_newton_bcsr`` and against the JAX package's
  ``sharded_newton`` / ``spmd_newton_bcsr`` on as many devices; padded
  rows 0; each rank's x has ``ndofs_pad / D`` entries.
"""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.apps.lid_driven import (  # noqa: E402
    cavity_bcs as jax_cavity_bcs)
from stabilized_navier_stokes_flow_fenicsx_tpu.assemble.assembly import (  # noqa: E402
    assembler_for_mixed as jax_assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem.bc import (  # noqa: E402
    bc_mask, bc_vector)
from stabilized_navier_stokes_flow_fenicsx_tpu.fem.space import (  # noqa: E402
    make_mixed_space as jax_make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms.navier_stokes import (  # noqa: E402
    make_ns_ugn_kernel as jax_ugn_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu.mesh.structured import (  # noqa: E402
    unit_square_tri as jax_unit_square_tri)
from stabilized_navier_stokes_flow_fenicsx_tpu.parallel import (  # noqa: E402
    shard as jax_shard)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes import (  # noqa: E402
    make_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import (  # noqa: E402
    shard)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (  # noqa: E402
    solve_linear_bcsr, solve_newton_bcsr)

from torch_cases import rel_l2  # noqa: E402
from torch_dist_cases import cavity_problem, run_ranks  # noqa: E402

N, RE = 8, 50.0
RANKS = (2, 4)


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_comm_layer(tmp_path, D):
    res = run_ranks("comm", D, tmp_path)
    ts = [np.arange(4.0) + 10.0 * r for r in range(D)]
    fulls = [np.arange(2.0 * D) * (r + 1) for r in range(D)]
    zero = np.zeros(2)
    for r, o in enumerate(res):
        assert np.array_equal(o["total"], sum(ts))
        assert float(o["scalar"]) == D * (D + 1) / 2
        nxt = ts[r + 1][:2] if r < D - 1 else zero
        prev = ts[r - 1][2:] if r > 0 else zero
        assert np.array_equal(o["fetched"], nxt)
        assert np.array_equal(o["pushed"], prev)
        assert np.array_equal(o["prev"], prev)
        assert np.array_equal(o["nxt"], nxt)
        assert np.array_equal(o["gathered"], np.concatenate(ts))
        assert np.array_equal(o["scattered"], sum(fulls)[2 * r:2 * r + 2])


@pytest.fixture(scope="module")
def cavity():
    """(port assembler, JAX assembler, mask, g, port kernel, JAX kernel,
    Stokes start w0, the port's single-process Newton result)."""
    asm, mask, g, kern = cavity_problem(N, RE)
    jmesh = jax_unit_square_tri(N, N)
    jW = jax_make_mixed_space(jmesh, 1, 1)
    jasm = jax_assembler_for_mixed(jW)
    jbc = jax_cavity_bcs(jmesh, jW)
    assert np.array_equal(bc_mask(jW.ndofs, jbc), mask)
    assert np.array_equal(bc_vector(jW.ndofs, jbc), g)
    pat = asm.pattern
    sk = make_stokes_kernel("triangle", nu=1 / RE, mu_T_coeff=1 / 3,
                            nu_scaled_stab=True)
    sres = solve_linear_bcsr(sk, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
                             1e-10, 50, asm.arrays, asm.vector(mask),
                             asm.vector(g))
    ref = solve_newton_bcsr(kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
                            asm.arrays, asm.vector(mask), asm.vector(g),
                            sres.x)
    assert ref.converged
    return (asm, jasm, mask, g, kern, jax_ugn_kernel("triangle", nu=1 / RE),
            sres.x.numpy(), ref)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_spmd_pad_problem_equals_jax(cavity, D):
    asm, jasm = cavity[:2]
    arrays, ndofs_pad, nnzb_pad, n_rows_pad = shard.spmd_pad_problem(asm, D)
    jarrays, *jsizes = jax_shard.spmd_pad_problem(jasm, D)
    assert [ndofs_pad, nnzb_pad, n_rows_pad] == [int(s) for s in jsizes]
    assert ndofs_pad % D == 0 and nnzb_pad % D == 0 and n_rows_pad % D == 0
    assert set(arrays) == set(jarrays._fields)
    for name, a in arrays.items():
        assert np.array_equal(a, np.asarray(getattr(jarrays, name))), name
        assert a.shape[0] % D == 0, name


@pytest.mark.parametrize("D", RANKS)
def test_sharded_newton_cavity(cavity, tmp_path, D):
    asm, jasm, mask, g, kern, jkern, w0, ref = cavity
    res = run_ranks("sharded_bcsr", D, tmp_path, dict(n=N, Re=RE),
                    dict(w0=w0))
    pat = asm.pattern
    _, ndofs_pad, _, _ = shard.spmd_pad_problem(asm, D)
    for o in res:
        # element-sharded: whole dof vectors, the same on every rank
        assert bool(o["converged"]) and int(o["iters"]) == ref.iters
        assert np.array_equal(o["x"], res[0]["x"])
        assert rel_l2(o["x"], ref.x) < 1e-8
        assert int(o["n_cells_local"]) == -(-asm.arrays.cell_dofs.shape[0]
                                            // D)
        assert int(o["nnz_local"]) == -(-pat.nnzb // D)
        # row-partitioned: each rank holds ndofs_pad / D entries
        assert bool(o["converged2"]) and int(o["iters2"]) == ref.iters
        assert int(o["n_local2"]) == ndofs_pad // D
        x2 = o["x2"]
        assert x2.shape == (ndofs_pad,)
        assert np.abs(x2[asm.ndofs:]).max() == 0.0      # padded rows pinned
        assert rel_l2(x2[:asm.ndofs], ref.x) < 1e-8

    # the JAX package on as many devices
    devs = np.array(jax.devices()[:D])
    jmask, jg, jw0 = jnp.asarray(mask), jnp.asarray(g), jnp.asarray(w0)
    jout = jax_shard.sharded_newton(
        jax_shard.make_sharded_problem(jasm, Mesh(devs, ("cells",))), jkern,
        jmask, jg, jw0)
    assert bool(jout.converged) and int(jout.iters) == int(res[0]["iters"])
    assert rel_l2(res[0]["x"], jout.x) < 1e-8
    jout2 = jax_shard.spmd_newton_bcsr(jasm, jkern, jmask, jg, jw0,
                                       Mesh(devs, ("dofs",)))
    assert bool(jout2.converged) and int(jout2.iters) == int(res[0]["iters2"])
    assert np.asarray(jout2.x).shape == res[0]["x2"].shape
    assert rel_l2(res[0]["x2"], jout2.x) < 1e-8


@pytest.mark.parametrize("method", ["cg", "tfqmr", "fgmres", "newton"])
def test_single_process_solvers_make_no_distributed_call(monkeypatch,
                                                         method):
    """With no ``reduce`` the Krylov methods and Newton touch nothing of
    ``torch.distributed``, and with a ``reduce`` every inner product goes
    through it (one rank: the sums are the whole ones, so the iterates
    agree to rounding)."""
    import torch
    import torch.distributed as dist

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (
        krylov, newton)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.distributed called")

    for name in ("all_reduce", "all_gather", "batch_isend_irecv",
                 "is_initialized", "get_world_size", "get_rank"):
        monkeypatch.setattr(dist, name, refuse)
    n = 40
    T = torch.diag(torch.full((n,), 4.0, dtype=torch.float64)) \
        - torch.diag(torch.ones(n - 1, dtype=torch.float64), 1) \
        - torch.diag(torch.ones(n - 1, dtype=torch.float64), -1)
    b = torch.linspace(1.0, 2.0, n, dtype=torch.float64)
    calls = []

    def reduce(t):
        calls.append(t.shape)
        return t

    def run(reduce):
        if method == "newton":
            out = newton.newton_solve(
                lambda x: T @ x + 0.1 * x ** 3 - b, lambda x: x,
                lambda x: (lambda v: T @ v + 0.3 * x ** 2 * v),
                lambda x: (lambda v: v / 4.0), torch.zeros_like(b),
                rtol=1e-12, atol=1e-12, ksp_rtol=1e-12, reduce=reduce)
        else:
            out = getattr(krylov, method)(lambda v: T @ v, b, rtol=1e-12,
                                          reduce=reduce)
        assert out.converged
        return out

    plain = run(None)
    assert not calls
    reduced = run(reduce)
    assert calls and plain.iters == reduced.iters
    assert rel_l2(reduced.x, plain.x) < 1e-12
