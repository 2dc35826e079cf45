"""Analytic FLOP / byte models (a copy of smmb_tpu/bench/flops.py).

The formulas are the reference benchmark's analytic counts:

    dense : 2·M·N·K + M·N            (reference main.cpp:293)
    sparse: 2·M·nnz + M·N            (reference main.cpp:47-51)

plus a byte model for roofline accounting.
"""

from __future__ import annotations


def dense_flops(m: int, n: int, k: int) -> int:
    """FLOPs of dense ``Y = X·W + B`` (reference main.cpp:293)."""
    return 2 * m * n * k + m * n


def sparse_flops(m: int, n: int, nnz: int) -> int:
    """Effective FLOPs of ternary SpMM + bias: one add/sub per stored ±1 per
    batch row, plus the bias add (reference main.cpp:47-51)."""
    return 2 * m * nnz + m * n


def spmm_bytes(
    m: int,
    n: int,
    k: int,
    *,
    weight_bytes: int,
    x_itemsize: int = 4,
    y_itemsize: int = 4,
    bias: bool = True,
) -> int:
    """Minimum device-memory traffic of one SpMM call: read X and W once, write Y once.

    ``weight_bytes`` is format-dependent: TernaryPacked.weight_bytes() for the
    2-bit path, 4·K·N for the reference's fp32 dense streaming.
    """
    return (
        m * k * x_itemsize
        + weight_bytes
        + m * n * y_itemsize
        + (4 * n if bias else 0)
    )
