"""The bytes and operations one call of the port's hand kernels must
move, and their least time on the card.

A frozen copy of ``chip_smoke.py``'s ``k1_bytes``/``k1_bound`` and
``k2_bytes``/``k2_bound``, written over the launch's shape rather than
the program's operand objects, so that the yardstick stays put when the
program changes.  Peaks: NVIDIA's H100 SXM data sheet (3.35 TB/s of HBM;
67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores).

No per-layer metric reads these yet: the roofline shares need each
launch's shape (E, Lp, n2d, type pair, masked), which the program does
not record.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 34e12, 4: 67e12}        # by the iterate's element size


def k1_bytes(E: int, Lp: int, n2d: int, vsize: int, asize: int,
             masked: bool) -> int:
    """K1 (``layered_spmv``): the 48 E Lp values (not the layout's
    padding) in the value type, x read once, the mask read once when
    fused, y written once (iterate type), and the pair tables."""
    ndofs = Lp * n2d * 4
    return (48 * E * Lp * vsize + (3 if masked else 2) * ndofs * asize
            + 8 * E + 8 * (n2d + 1))


def k1_bound(E: int, Lp: int, n2d: int, vsize: int, asize: int,
             masked: bool):
    """(bound_ms, "bytes" | "operations")."""
    t_bytes = k1_bytes(E, Lp, n2d, vsize, asize, masked) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 48 * E * Lp / PEAK_FLOPS[asize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_bytes(E: int, Lp: int, n2d: int, vsize: int, asize: int) -> int:
    """K2 (``plane_gs``): the three value slices and the block inverses
    once (value type), the mask and r read once and x written once
    (iterate type), and the pair tables."""
    ndofs = Lp * n2d * 4
    return ((3 * E + n2d) * Lp * 16 * vsize + 3 * ndofs * asize
            + 8 * E + 8 * (n2d + 1))


def k2_bound(E: int, Lp: int, n2d: int, vsize: int, asize: int,
             inner_sweeps: int, symmetric: bool):
    """(bound_ms, "bytes" | "operations").  Per plane and direction: the
    coupling product and ``inner_sweeps`` products with V0, each stage
    with a 4x4 block inverse per row."""
    t_bytes = k2_bytes(E, Lp, n2d, vsize, asize) / HBM_BYTES_PER_S * 1e3
    per_plane = (1 + inner_sweeps) * (2 * 16 * E + 2 * 16 * n2d)
    flops = (2 if symmetric else 1) * Lp * per_plane
    t_ops = flops / PEAK_FLOPS[asize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
