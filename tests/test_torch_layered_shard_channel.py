"""``sharded_newton_layered`` with ``pc="mg"`` on the CHANNEL mesh
(splitter, unused-node rows, inlet profiles) on 2 and 4 gloo ranks:
against the port's single-process ``solve_newton_layered`` with
``mg_cheby`` and the JAX package's sharded solve on as many devices,
relative L2 < 1e-8 with equal Newton step counts and FGMRES counts within
1; padded-plane dofs 0 to 1e-14 of the largest dof.  Float64 on the CPU;
the rank processes run tests/torch_dist_cases.py.
"""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import (  # noqa: E402
    layered as jax_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu.parallel import (  # noqa: E402
    layered_shard as jax_shard)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.layered import (  # noqa: E402
    build_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import (  # noqa: E402
    layered_shard)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (  # noqa: E402
    solve_newton_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.mg import (  # noqa: E402
    build_mg_hierarchy)

from torch_cases import rel_l2  # noqa: E402
from torch_dist_cases import run_ranks  # noqa: E402
from torch_shard_cases import (RANKS, TOLS, _params, img,  # noqa: E402,F401
                               problems)


@pytest.fixture(scope="module")
def channel_single_process(problems):
    """The port's single-process ``mg_cheby`` Newton on the CHANNEL mesh
    (structured assembly, the whole V-cycle in one process)."""
    tm, tW, mask, g, kern = problems["channel"][1]
    n2d, Lp, _ = tm.layered
    lp1 = build_layered(tW, n2d, Lp, device="cpu")
    hier = build_mg_hierarchy(lp1.rows2d, lp1.cols2d, n2d, Lp,
                              mask.astype(np.float32), lp1.bs, n_levels=2,
                              device="cpu")
    g_t = torch.as_tensor(g)
    out1 = solve_newton_layered(
        kern, n2d, Lp, lp1.bs, lp1.arrays, torch.as_tensor(mask), g_t, g_t,
        lp1.E, 1e-12, 1e-12, 30, 1e-10, 50, 40, "mg_cheby", hier)
    assert out1.converged
    return out1


@pytest.mark.parametrize("D", RANKS)
def test_plane_sharded_mg_channel(problems, channel_single_process, img,
                                  tmp_path, D):
    """pc="mg" on the CHANNEL mesh (splitter, unused-node rows, inlet
    profiles) against the port's single-process ``mg_cheby`` solve and
    the JAX package's sharded solve."""
    tm, tW, mask, g, kern = problems["channel"][1]
    out1 = channel_single_process
    res = run_ranks("layered_newton", D, tmp_path,
                    dict(pc="mg", mg_levels=2, tols=TOLS,
                         **_params("channel", img)))
    o = res[0]
    assert bool(o["converged"]) and int(o["iters"]) == out1.iters
    assert rel_l2(o["x"][:tW.ndofs], out1.x) < 1e-8
    # the V-cycle's prolongation pairs the first padded plane with the last
    # real one, so FGMRES pins the padded dofs to 0 only to its tolerance
    # (the exact 0 is the Jacobi case's, as in the JAX package's tests)
    assert np.abs(o["x"][tW.ndofs:]).max(initial=0.0) \
        <= 1e-14 * np.abs(o["x"]).max()
    assert np.abs(o["history"][:, 2] - out1.history[:, 2]).max() <= 1

    # the JAX package's sharded V-cycle solve on as many devices
    (jm, jW, jmask, jg, jkern), _ = problems["channel"]
    n2d, Lp, _ = jm.layered
    Lp_pad = layered_shard.padded_planes(Lp, D)
    dmesh = Mesh(np.array(jax.devices()[:D]), ("planes",))
    jlp = jax_layered.build_layered(jW, n2d, Lp_pad)
    mask_p, g_p = jax_shard.pad_mask_g(jmask, jg, n2d * Lp_pad * jlp.bs)
    ref = jax_shard.sharded_newton_layered(
        jkern, jlp, mask_p, g_p, g_p, dmesh, pc="mg", mg_levels=2, **TOLS)
    assert bool(ref.converged)
    assert int(o["iters"]) == int(ref.iters)
    assert rel_l2(o["x"], ref.x) < 1e-8
    its_ref = np.asarray(ref.history)[:int(ref.iters), 2]
    assert np.abs(o["history"][:, 2] - its_ref).max() <= 1
