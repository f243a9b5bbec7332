"""CG, BiCGStab, TFQMR and MINRES of the port against the JAX package.

The seeded operators of tests/test_krylov.py (1D convection-diffusion,
nonsymmetric; symmetric at Peclet 0) and tests/test_taylor_hood.py (a
symmetric indefinite saddle point with an SPD block-diagonal
preconditioner), float64 on the CPU, the same numpy inputs on both
sides.  Iterations within +-1 (TFQMR: matvecs), x to relative 1e-10,
``converged`` equal; a zero right-hand side converges at once to x = 0.

The sizes and tolerances are ones where the count is not decided by
rounding: on these 1D operators the Krylov methods end near their n-th
step, and there TFQMR's count moves by up to +-20 under 1e-15 relative
perturbations of b (conv_diff(80, Pe 35) at rtol 1e-11, or (120, Pe 20)
with Jacobi), in the JAX package and the port alike.  The cases kept
move by at most 1 under such perturbations.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.solve import (  # noqa: E402
    krylov as jax_krylov)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.solve import (  # noqa: E402
    krylov)

import torch_cases  # noqa: E402,F401  (one intra-op thread)


def _conv_diff(n, peclet=20.0):
    """tests/test_krylov.py's operator."""
    h = 1.0 / (n + 1)
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = 2.0 / h**2
        if i > 0:
            A[i, i - 1] = -1.0 / h**2 - peclet / (2 * h)
        if i < n - 1:
            A[i, i + 1] = -1.0 / h**2 + peclet / (2 * h)
    return A


def _saddle():
    """tests/test_taylor_hood.py:46's saddle point and SPD preconditioner."""
    rng = np.random.default_rng(7)
    n, m = 24, 8
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A11 = Q @ np.diag(rng.uniform(1.0, 10.0, n)) @ Q.T
    B = rng.standard_normal((n, m))
    K = np.block([[A11, B], [B.T, np.zeros((m, m))]])
    b = K @ rng.standard_normal(n + m)
    dinv = np.concatenate([1.0 / np.diag(A11), np.ones(m)])
    return K, b, dinv, A11


def _case(name):
    """(method, A, b, Jacobi inverse diagonal or None, kwargs)."""
    if name == "saddle_minres":
        K, b, dinv, _ = _saddle()
        return "minres", K, b, dinv, dict(rtol=1e-10)
    if name == "spd_block_cg":
        _, _, _, A11 = _saddle()
        b = np.random.default_rng(2).standard_normal(A11.shape[0])
        return "cg", A11, b, 1.0 / np.diag(A11), dict(rtol=1e-12)
    method, n, peclet, pc, rtol, seed = {
        "cg_plain": ("cg", 60, 0.0, False, 1e-12, 7),
        "cg_jacobi": ("cg", 120, 0.0, True, 1e-10, 3),
        "bicgstab_plain": ("bicgstab", 60, 20.0, False, 1e-12, 7),
        "bicgstab_jacobi": ("bicgstab", 80, 35.0, True, 1e-11, 11),
        "tfqmr_plain": ("tfqmr", 60, 20.0, False, 1e-12, 7),
        "tfqmr_jacobi": ("tfqmr", 60, 20.0, True, 1e-10, 3),
        "tfqmr_jacobi_pe10": ("tfqmr", 80, 10.0, True, 1e-10, 3),
    }[name]
    A = _conv_diff(n, peclet)
    b = np.random.default_rng(seed).standard_normal(n)
    return method, A, b, (1.0 / np.diag(A)) if pc else None, \
        dict(rtol=rtol, max_it=8000)


def _run_both(method, A, b, dinv, kw):
    Aj, At = jnp.asarray(A), torch.tensor(A)
    Mj = None if dinv is None else (lambda v, d=jnp.asarray(dinv): d * v)
    Mt = None if dinv is None else (lambda v, d=torch.tensor(dinv): d * v)
    ref = getattr(jax_krylov, method)(lambda v: Aj @ v, jnp.asarray(b),
                                      M=Mj, **kw)
    out = getattr(krylov, method)(lambda v: At @ v, torch.tensor(b), M=Mt,
                                  **kw)
    return ref, out


@pytest.mark.parametrize("name", [
    "cg_plain", "cg_jacobi", "spd_block_cg", "bicgstab_plain",
    "bicgstab_jacobi", "tfqmr_plain", "tfqmr_jacobi", "tfqmr_jacobi_pe10",
    "saddle_minres"])
def test_matches_jax(name):
    method, A, b, dinv, kw = _case(name)
    ref, out = _run_both(method, A, b, dinv, kw)
    assert out.converged == bool(ref.converged) and out.converged
    assert abs(out.iters - int(ref.iters)) <= 1, (out.iters, int(ref.iters))
    x_ref = np.asarray(ref.x)
    assert np.linalg.norm(out.x.numpy() - x_ref) <= \
        1e-10 * np.linalg.norm(x_ref)


@pytest.mark.parametrize("method", ["cg", "bicgstab", "tfqmr", "minres"])
def test_zero_rhs(method):
    A = _conv_diff(16, 0.0 if method in ("cg", "minres") else 20.0)
    ref, out = _run_both(method, A, np.zeros(16), None,
                         dict(rtol=1e-10, max_it=100))
    assert out.converged and bool(ref.converged)
    assert out.iters == int(ref.iters) == 0
    assert float(torch.linalg.vector_norm(out.x)) == 0.0


def test_tfqmr_max_it_counts_matvecs():
    """A budget of 7 matvecs stops TFQMR after 7 half-steps on both sides,
    unconverged."""
    A = _conv_diff(60)
    b = np.random.default_rng(7).standard_normal(60)
    ref, out = _run_both("tfqmr", A, b, None, dict(rtol=1e-12, max_it=7))
    assert out.iters == int(ref.iters) == 7
    assert not out.converged and not bool(ref.converged)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(ref.x)).max())
