"""Shared shape/alignment helpers (counterpart of smmb_tpu/utils/shapes.py)."""


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return (x + m - 1) // m * m
