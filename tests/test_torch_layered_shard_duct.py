"""``sharded_newton_layered`` on the duct (6, 13) on 2 and 4 gloo ranks,
with ``pc="jacobi"`` and ``pc="mg"``: against the port's single-process
block-CSR Newton and the JAX package's ``sharded_newton_layered`` on as
many devices, relative L2 < 1e-8 with equal Newton step counts and
FGMRES counts within 1; padded-plane dofs exactly 0.  The Jacobi cases
run their inner solves to 1e-6 (``_tols``).  Float64 on the
CPU; the rank processes run tests/torch_dist_cases.py.
"""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.assemble import (  # noqa: E402
    layered as jax_layered)
from stabilized_navier_stokes_flow_fenicsx_tpu.parallel import (  # noqa: E402
    layered_shard as jax_shard)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble.assembly import (  # noqa: E402
    assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel import (  # noqa: E402
    layered_shard)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve.driver import (  # noqa: E402
    solve_newton_bcsr)

from torch_cases import rel_l2  # noqa: E402
from torch_dist_cases import run_ranks  # noqa: E402
from torch_shard_cases import RANKS, TOLS, img, problems  # noqa: E402,F401


def _tols(pc):
    """The Newton tolerances of a case.  The Jacobi cases' inner solves
    stop at 1e-6: their FGMRES then runs ~680 iterations on the duct
    against ~1,110 at 1e-10, with the same 5 Newton steps to the same
    1e-12 and solutions within 1e-15 of each other (the bars are 1e-8)."""
    return dict(TOLS, ksp_rtol=1e-6) if pc == "jacobi" else TOLS


@pytest.fixture(scope="module")
def duct_single_process(problems):
    """{pc: the port's single-process Newton on the duct (block-CSR,
    node-block Jacobi) at that case's tolerances}."""
    _, W, mask, g, kern = problems["duct"][1]
    asm = assembler_for_mixed(W, device="cpu")
    pat = asm.pattern
    out = {}
    for pc in ("jacobi", "mg"):
        out[pc] = solve_newton_bcsr(
            kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays,
            asm.vector(mask), asm.vector(g), asm.vector(g), **_tols(pc))
        assert out[pc].converged
    return out


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("pc", ["jacobi", "mg"])
def test_plane_sharded_duct(problems, duct_single_process, tmp_path, pc, D):
    (jm, jW, jmask, jg, jkern), _ = problems["duct"]
    tols = _tols(pc)
    res = run_ranks("layered_newton", D, tmp_path,
                    dict(geometry="duct", n_cross=6, n_axial=13, Re=20.0,
                         pc=pc, mg_levels=2, tols=tols))
    nd = jW.ndofs
    n2d, Lp, _ = jm.layered
    Lp_pad = layered_shard.padded_planes(Lp, D)
    for o in res:
        assert bool(o["converged"])
        assert int(o["n_local"]) == n2d * Lp_pad * 4 // D
        assert np.array_equal(o["x"], res[0]["x"])
    x = res[0]["x"]
    assert x.shape == (n2d * Lp_pad * 4,)
    assert rel_l2(x[:nd], duct_single_process[pc].x) < 1e-8
    # padded-plane dofs stayed at their identity value 0
    assert np.abs(x[nd:]).max(initial=0.0) == 0.0

    # the JAX package's sharded solve on as many devices
    dmesh = Mesh(np.array(jax.devices()[:D]), ("planes",))
    jlp = jax_layered.build_layered(jW, n2d, Lp_pad)
    mask_p, g_p = jax_shard.pad_mask_g(jmask, jg, n2d * Lp_pad * jlp.bs)
    ref = jax_shard.sharded_newton_layered(
        jkern, jlp, mask_p, g_p, g_p, dmesh, pc=pc, mg_levels=2, **tols)
    assert bool(ref.converged)
    assert int(res[0]["iters"]) == int(ref.iters)
    assert rel_l2(x, ref.x) < 1e-8
    its_ref = np.asarray(ref.history)[:int(ref.iters), 2]
    assert np.abs(res[0]["history"][:, 2] - its_ref).max() <= 1
