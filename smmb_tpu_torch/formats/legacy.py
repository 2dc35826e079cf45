"""Legacy threshold-based format construction
(counterpart of smmb_tpu/formats/legacy.py).

The reference's original course code builds its formats from an int matrix
with threshold compares, ``>= 1`` → +1 and ``<= -1`` → -1, unlike the exact
``== ±1.0`` compares of the modern path. These wrappers reproduce the
threshold semantics for every format; the kernels then multiply by implicit
±1 whatever the stored magnitude, so the oracle is
``gemm(x, ternarize_threshold(w), b)`` at the legacy tolerance 1e-5.
"""

from __future__ import annotations

import numpy as np
import torch

from smmb_tpu_torch.formats.bcsr import BCSR, bcsr_from_dense
from smmb_tpu_torch.formats.packed import TernaryPacked, pack_ternary
from smmb_tpu_torch.formats.tcsc import TCSC, tcsc_from_dense


def ternarize_threshold(w) -> np.ndarray:
    """Int/float matrix → float32 ternary (numpy): ``w >= 1`` → +1.0,
    ``w <= -1`` → -1.0, else 0.0."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w)
    t = np.zeros(w.shape, dtype=np.float32)
    t[w >= 1] = 1.0
    t[w <= -1] = -1.0
    return t


def tcsc_from_dense_threshold(w, device=None) -> TCSC:
    """TCSC from an int matrix with threshold compares."""
    return tcsc_from_dense(ternarize_threshold(w), device=device)


def pack_ternary_threshold(w, device=None) -> TernaryPacked:
    """Threshold-semantics packing into the 2-bit execution format."""
    return pack_ternary(ternarize_threshold(w), device=device)


def bcsr_from_dense_threshold(w, r: int, c: int, device=None) -> BCSR:
    """Threshold-semantics BCSR construction."""
    return bcsr_from_dense(ternarize_threshold(w), r, c, device=device)
