"""The port's root entry points (``__graft_entry_torch__.py``) against
the JAX package's (``__graft_entry__.py``), and ``solve_dense_qr``.

* ``entry()``: the forward step on the tiny duct (residual norm and one
  block-Jacobi apply) against the JAX package's at its example argument
  and at a seeded state, relative 1e-10;
* ``dryrun_multichip(4)`` on 4 gloo ranks of the CPU: one
  element-sharded Newton step, the plane-sharded lc=0.2 channel solve
  (3 Newton steps, V-cycle) within 1e-5 of the single-process solve, one
  row-partitioned step with equal shard lengths (it raises otherwise);
* ``utils.solve_dense_qr`` against the JAX package's, 1e-12.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu.utils import (  # noqa: E402
    solve_dense_qr as jax_solve_dense_qr)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import (  # noqa: E402
    solve_dense_qr)

import __graft_entry__ as jax_entry  # noqa: E402
import __graft_entry_torch__ as torch_entry  # noqa: E402

from torch_cases import rel_l2  # noqa: E402


@pytest.fixture(scope="module")
def steps():
    fn, args = torch_entry.entry(device="cpu")
    jfn, jargs = jax_entry.entry()
    return fn, args, jfn, jargs


def test_entry_example_args(steps):
    fn, args, jfn, jargs = steps
    assert len(args) == 1 and args[0].device.type == "cpu"
    assert args[0].dtype == torch.float64
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))


@pytest.mark.parametrize("state", ["example", "seeded"])
def test_entry_forward_step(steps, state):
    fn, args, jfn, jargs = steps
    w = np.asarray(jargs[0])
    if state == "seeded":
        w = np.random.default_rng(7).standard_normal(w.shape) * 0.1
    rn, z = fn(torch.as_tensor(w))
    jrn, jz = jfn(jnp.asarray(w))
    assert abs(float(rn) - float(jrn)) <= 1e-10 * float(jrn)
    assert rel_l2(z, jz) <= 1e-10
    assert z.shape == args[0].shape


def test_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        torch_entry.entry()


def _noop_rank(rank, n_ranks, device):
    pass


def test_spawn_ranks_raises_without_a_card():
    """The launcher starts the ranks on the cards unless asked for the
    CPU: with no card it raises before it starts a process."""
    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.parallel.launch import (
        spawn_ranks)

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        spawn_ranks(_noop_rank, 2)


def test_script_raises_without_a_card():
    """``python3 __graft_entry_torch__.py`` with no ``--device`` runs
    entry() on the card and does not carry on on the CPU without one."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    run = subprocess.run([sys.executable, torch_entry.__file__],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert "no CUDA card" in run.stderr
    assert "entry ok" not in run.stdout and "dryrun" not in run.stdout


@pytest.mark.parametrize("n", [4])
def test_dryrun_multichip(n):
    torch_entry.dryrun_multichip(n)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_solve_dense_qr(rhs):
    rng = np.random.default_rng(11)
    A = rng.standard_normal((24, 24)) + 4.0 * np.eye(24)
    b = rng.standard_normal(24 if rhs == "vector" else (24, 3))
    x = solve_dense_qr(torch.as_tensor(A), torch.as_tensor(b))
    ref = jax_solve_dense_qr(jnp.asarray(A), jnp.asarray(b))
    assert x.shape == b.shape
    assert rel_l2(x, ref) <= 1e-12
    assert np.abs(A @ x.numpy() - b).max() <= 1e-12
