"""The port's Taylor-Hood (P2-P1) duct Stokes path against the JAX
package, float64 on the CPU.

* ``make_stokes_th_kernel``, both sign conventions, on seeded
  tetrahedra and triangles: residual relative 1e-12 against JAX, and
  the ``jacfwd`` tangent of the symmetric form is symmetric;
* ``solve_duct_th(4, 8, "poiseuille")`` with ``method="schur"`` on both
  sides: outer FGMRES iterations within +-1, velocity relative 1e-8, and
  pressure relative 1e-8 on the live pressure dofs.  Some inlet-rim
  vertices are null pivots of the saddle point (every velocity dof they
  couple to is constrained): the host LU pins them to zero
  (solve/newton_host.py), the Schur solve leaves them undetermined and
  its residual stalls on their rows, in JAX and in the port alike, so
  both run to ``max_outer`` with every other dof converged;
* ``method="lu"`` against JAX (relative 1e-10) and against the port's
  Schur solve on the same mesh (velocity 1e-10, live pressure 1e-8);
* the three cases of tests/test_taylor_hood.py on the port.  The (6, 12)
  solve of the convergence case runs ``method="lu"`` here: its Schur
  solve takes minutes on one CPU thread and gives the same velocity (the
  check above); the Schur solve at (6, 12) runs on the card
  (``chip_smoke.py``).
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.apps import (  # noqa: E402
    duct_stokes_th as jax_app)
from stabilized_navier_stokes_flow_fenicsx_tpu.forms import (  # noqa: E402
    stokes_th as jax_th)
from stabilized_navier_stokes_flow_fenicsx_tpu.solve import (  # noqa: E402
    stokes_th as jax_schur)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.duct_stokes_th import (  # noqa: E402
    main, solve_duct_th)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.forms.stokes_th import (  # noqa: E402
    make_stokes_th_kernel)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    krylov)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.exact import (  # noqa: E402
    square_duct_mean, square_duct_profile)

from torch_cases import rel_l2  # noqa: E402

torch.set_num_threads(1)


def _seeded_cells(cell, nc, seed):
    rng = np.random.default_rng(seed)
    dim = 3 if cell == "tetrahedron" else 2
    ref = np.vstack([np.zeros(dim), np.eye(dim)])
    coords = np.stack([
        ref @ (np.eye(dim) + 0.3 * rng.standard_normal((dim, dim))).T
        + rng.standard_normal(dim) for _ in range(nc)])
    nv = 10 if dim == 3 else 6
    return coords, rng.standard_normal((nc, nv * dim + dim + 1))


@pytest.mark.parametrize("cell", ["tetrahedron", "triangle"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_stokes_th_kernel(cell, symmetric):
    coords, w = _seeded_cells(cell, 11, seed=4)
    kj = jax_th.make_stokes_th_kernel(cell, nu=0.7,
                                      symmetric_signs=symmetric)
    kt = make_stokes_th_kernel(cell, nu=0.7, symmetric_signs=symmetric)
    for c, we in zip(coords, w):
        r_ref = np.asarray(kj(jnp.asarray(c), jnp.asarray(we)))
        r = kt(torch.tensor(c), torch.tensor(we))
        assert r.shape == (w.shape[1],)
        assert rel_l2(r, r_ref) <= 1e-12
    J = torch.func.jacfwd(lambda ww: kt(torch.tensor(coords[0]), ww))(
        torch.tensor(w[0]))
    sym_err = float((J - J.T).abs().max() / J.abs().max())
    assert (sym_err <= 1e-14) == symmetric


def _rel_err(r):
    uex = square_duct_profile(r.u_coords[:, 1], r.u_coords[:, 2]) \
        / square_duct_mean()
    return float(np.sqrt(np.mean((r.u[:, 0] - uex) ** 2))
                 / np.sqrt(np.mean(uex**2)))


@pytest.fixture(scope="module")
def schur48():
    return solve_duct_th(4, 8, inlet="poiseuille", device="cpu")


@pytest.fixture(scope="module")
def lu48():
    return solve_duct_th(4, 8, inlet="poiseuille", method="lu",
                         device="cpu")


def _live(lu):
    """Pressure dofs the host LU did not pin as null pivots."""
    live = lu.p != 0.0
    assert 4 <= (~live).sum() <= 32
    return live


def test_schur_against_jax(schur48, lu48, monkeypatch):
    seen = {}
    orig = jax_schur.solve_th_schur

    def spy(*a, **k):
        seen["res"] = orig(*a, **k)
        return seen["res"]

    monkeypatch.setattr(jax_schur, "solve_th_schur", spy)
    ref = jax_app.solve_duct_th(4, 8, inlet="poiseuille")
    assert abs(schur48.outer_iters - int(seen["res"].outer_iters)) <= 1
    assert schur48.inner_iters >= schur48.outer_iters
    live = _live(lu48)
    assert rel_l2(schur48.u, ref.u) <= 1e-8
    assert rel_l2(schur48.p[live], ref.p[live]) <= 1e-8


def test_lu_against_jax_and_schur(schur48, lu48):
    ref = jax_app.solve_duct_th(4, 8, inlet="poiseuille", method="lu")
    assert rel_l2(lu48.u, ref.u) <= 1e-10
    assert rel_l2(lu48.p, ref.p) <= 1e-10
    live = _live(lu48)
    assert rel_l2(schur48.u, lu48.u) <= 1e-10
    assert rel_l2(schur48.p[live], lu48.p[live]) <= 1e-8


def test_th_duct_converges(schur48):
    e4 = _rel_err(schur48)
    e6 = _rel_err(solve_duct_th(6, 12, inlet="poiseuille", method="lu",
                                device="cpu"))
    assert e6 < e4 / 1.8
    assert e6 < 0.06


def test_th_uniform_inlet_mass_and_main(capsys):
    """The uniform-inlet case through ``main`` (n = 4): the mass bar of
    tests/test_taylor_hood.py, and the JAX app's four printed lines (the
    velocity norms relative 1e-6; the pressure norms are taken over the
    undetermined rim dofs too and are not compared)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(["4"])
    r = main(["4"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    jax_app.main(["4"])
    ref = capsys.readouterr().out.splitlines()
    assert len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        assert a.split(":")[0] == b.split(":")[0]
    for k in (0, 2):
        va, vb = (float(x.split(":")[1]) for x in (out[k], ref[k]))
        assert abs(va - vb) <= 1e-6 * abs(vb)

    mesh = r.mesh
    f = mesh.facets[mesh.facet_markers == 3]
    tp = mesh.points[f]
    ar = np.linalg.norm(np.cross(tp[:, 1] - tp[:, 0],
                                 tp[:, 2] - tp[:, 0]) / 2, axis=1)
    # exact P2 facet integral: area/3 * sum of edge-midpoint values
    en = r.space.V.edge_nodes
    key = {(min(a, b), max(a, b)): i for i, (a, b) in enumerate(en)}
    flux = 0.0
    for fac, a in zip(f, ar):
        mids = [mesh.n_nodes + key[(min(fac[i], fac[j]),
                                    max(fac[i], fac[j]))]
                for i, j in ((0, 1), (1, 2), (0, 2))]
        flux += a / 3 * sum(r.u[m, 0] for m in mids)
    assert abs(flux - 1.0) < 0.03


def test_minres_symmetric_indefinite():
    """The port's minres on a small symmetric indefinite saddle point
    with an SPD block-diagonal preconditioner."""
    rng = np.random.default_rng(7)
    n, m = 24, 8
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A11 = Q @ np.diag(rng.uniform(1.0, 10.0, n)) @ Q.T
    B = rng.standard_normal((n, m))
    K = torch.tensor(np.block([[A11, B], [B.T, np.zeros((m, m))]]))
    x_exact = rng.standard_normal(n + m)
    b = K @ torch.tensor(x_exact)
    dinv = torch.tensor(np.concatenate([1.0 / np.diag(A11), np.ones(m)]))
    out = krylov.minres(lambda x: K @ x, b, M=lambda x: dinv * x,
                        rtol=1e-10)
    assert out.converged, out.resnorm
    assert rel_l2(out.x, x_exact) < 1e-7
