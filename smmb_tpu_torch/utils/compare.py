"""Elementwise validation utilities (counterpart of smmb_tpu/utils/compare.py).

The reference validates every kernel against a dense oracle before measuring
and hard-exits on the first mismatch. Two tolerances exist: abs 1e-4 on the
modern path and abs 1e-5 on the legacy path. Both are kept as named
constants, and the first mismatch is reported like the reference does.
Inputs may be numpy arrays or torch tensors on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# reference dense.c:43 (`fabs(a-b) > 1e-4`)
TOL_DENSE = 1e-4
# reference SparseGEMM.h:176 (`fabs(a-b) > 10e-6`)
TOL_LEGACY = 1e-5


@dataclasses.dataclass(frozen=True)
class CompareResult:
    ok: bool
    max_abs_err: float
    first_mismatch: tuple | None  # (flat_index, a_val, b_val) or None

    def __bool__(self) -> bool:
        return self.ok


def _as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, dtype=np.float32).ravel()


def compare(a, b, tol: float = TOL_DENSE) -> CompareResult:
    """Absolute-tolerance elementwise compare with first-mismatch reporting."""
    a = _as_f32(a)
    b = _as_f32(b)
    if a.shape != b.shape:
        return CompareResult(False, float("inf"), None)
    err = np.abs(a - b)
    bad = err > tol
    if not bad.any():
        return CompareResult(True, float(err.max(initial=0.0)), None)
    i = int(np.argmax(bad))
    return CompareResult(False, float(err.max()), (i, float(a[i]), float(b[i])))


def assert_close(a, b, tol: float = TOL_DENSE, what: str = "") -> None:
    """Raise AssertionError with the reference-style mismatch report."""
    r = compare(a, b, tol)
    if not r.ok:
        i, av, bv = r.first_mismatch if r.first_mismatch else (-1, 0, 0)
        raise AssertionError(
            f"{what or 'compare'}: mismatch at flat index {i}: "
            f"{av} vs {bv} (max abs err {r.max_abs_err:.3e}, tol {tol})"
        )
