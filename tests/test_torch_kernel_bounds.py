"""The kernels' yardsticks (tests/torch_kernel_bounds.py) on the CPU, no
card and no jax: K1's and K2's bounds are the benchmark's frozen formulas
(portbench/harness/kernels.py) at the operand's shape and types, to the
values PERF.md records for the lc=0.04 and lc=0.024 levels; K3's bytes
and chain bounds count what the docstring says.

The operands are stand-ins with the attributes the bounds read; their
tensors live on the meta device, so the full-size shapes cost nothing.
"""

import types

import pytest
import torch

import torch_kernel_bounds as kb

F64, F32, BF16 = torch.float64, torch.float32, torch.bfloat16


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape,pair,want", [
    ((5037, 77, 749), (F64, F64), 0.0461),      # lc 0.04
    ((5037, 77, 749), (BF16, F32), 0.0120),
    ((5037, 77, 749), (F64, F32), 0.0453),
    ((14064, 128, 2058), (F64, F64), 0.2139),   # lc 0.024
    ((14064, 128, 2058), (BF16, F32), 0.0554),
])
def test_k1_bound_is_the_frozen_formula_at_the_level(shape, pair, want):
    E, Lp, n2d = shape
    level = types.SimpleNamespace(values=_meta((4, 4, 3, E, Lp), F64),
                                  n_planes=Lp, n2d=n2d)
    ms, by = kb.k1_bound(level, *pair, True)
    assert by == "bytes" and round(ms, 4) == want


@pytest.mark.parametrize("shape,pair,want", [
    ((5037, 77, 749), (F64, F64), 0.0483),
    ((1471, 39, 225), (F64, F64), 0.0072),
    ((14064, 128, 2058), (F64, F64), 0.2240),
    ((14064, 128, 2058), (BF16, F32), 0.0579),
])
def test_k2_bound_is_the_frozen_formula_at_the_operand(shape, pair, want):
    E, Lp, n2d = shape
    vdtype, adtype = pair
    op = types.SimpleNamespace(
        E=E, Lp=Lp, n2d=n2d, values=_meta((3 * E + n2d, Lp, 16), vdtype),
        mask=_meta((Lp * n2d * 4,), adtype), inner_sweeps=2, symmetric=True)
    ms, by = kb.k2_bound(op)
    assert by == "bytes" and round(ms, 4) == want


def test_k3_bounds_count_the_tables_the_seeds_and_the_chain():
    dloc = types.SimpleNamespace(
        x_planes=torch.zeros(10, dtype=F64), tab2=torch.zeros(3, 7),
        prism_base=torch.zeros(5, dtype=torch.int64),
        prism_geom=torch.zeros(2, 12, dtype=F64))
    u_cell = torch.zeros(4, 6, dtype=F64)
    x0 = torch.zeros(100, 3, dtype=F64)
    nbytes, bytes_ms, chain_ms = kb.k3_bounds(dloc, u_cell, x0, 250, 20.0)
    tables = 10 * 8 + 21 * 4 + 5 * 8 + 24 * 8 + 24 * 8
    assert nbytes == tables + 2 * 300 * 8 + 9 * 100
    assert bytes_ms == nbytes / kb.HBM_BYTES_PER_S * 1e3
    assert chain_ms == pytest.approx(250 * 6 * 4 * 20.0 * 1e-6, rel=1e-15)
