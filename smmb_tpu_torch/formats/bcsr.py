"""BCSR — Block Compressed Sparse Row, as a dataclass of tensors
(counterpart of smmb_tpu/formats/bcsr.py).

The K×N ternary weight matrix is tiled into r×c blocks; only blocks that
hold at least one exact ±1 are stored.

    b_row_start : int32[br + 1]       CSR pointers over block rows (br = K // r)
    b_col_idx   : int32[k]            block column of each stored block
    b_values    : float32[k, r, c]    explicit block values (±1/0 floats)

SpMM semantics: ``Y[m, bc*c + j] += X[m, br*r + i] * b_values[bi, i, j]``,
each stored block a dense r×c sub-matrix of W.

``b_row_start`` is a cumulative count over block rows, so an all-zero block
row gives an empty run (the JAX package's fix of the reference
constructor, which advanced the pointer only for block rows holding a
block). Construction is a numpy scan on the host; the arrays are bitwise
JAX's for the same input and are then placed on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smmb_tpu_torch.formats.tcsc import _dense_np, _host
from smmb_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BCSR:
    """BCSR matrix on one device (see the module docstring for the layout)."""

    b_row_start: torch.Tensor  # int32[br + 1]
    b_col_idx: torch.Tensor  # int32[k]
    b_values: torch.Tensor  # float32[k, r, c]
    rows: int  # K
    cols: int  # N
    r: int  # block rows
    c: int  # block cols
    br: int  # grid rows = rows // r
    bc: int  # grid cols = cols // c
    k: int  # number of stored blocks

    @property
    def shape(self):
        return (self.rows, self.cols)

    @property
    def nnz(self) -> int:
        """Stored elements (explicit zeros inside kept blocks included)."""
        return self.k * self.r * self.c

    @property
    def device(self) -> torch.device:
        return self.b_values.device

    def value_bytes(self) -> int:
        return 4 * self.k * self.r * self.c + 4 * (self.br + 1 + self.k)


def bcsr_from_dense(w, r: int, c: int, device=None) -> BCSR:
    """Dense (K × N) ternary matrix → BCSR with r×c blocks on ``device``.

    A block is kept iff it holds an entry exactly equal to ±1.0. K % r and
    N % c must be 0, else ``ValueError``.
    """
    dev = resolve_device(device)
    w = _dense_np(w)
    rows, cols = w.shape
    if rows % r or cols % c:
        raise ValueError(f"shape {w.shape} not divisible by block ({r}, {c})")
    br, bc = rows // r, cols // c
    blocks = w.reshape(br, r, bc, c).transpose(0, 2, 1, 3)  # (br, bc, r, c)
    valid = np.any((blocks == 1.0) | (blocks == -1.0), axis=(2, 3))
    brow_hit, bcol_hit = np.nonzero(valid)  # row-major scan order
    counts = np.bincount(brow_hit, minlength=br)
    b_row_start = np.zeros(br + 1, dtype=np.int32)
    np.cumsum(counts, out=b_row_start[1:])
    b_values = np.ascontiguousarray(blocks[brow_hit, bcol_hit], dtype=np.float32)
    return BCSR(
        b_row_start=torch.from_numpy(b_row_start).to(dev),
        b_col_idx=torch.from_numpy(bcol_hit.astype(np.int32)).to(dev),
        b_values=torch.from_numpy(b_values.reshape(len(bcol_hit), r, c)).to(dev),
        rows=rows, cols=cols, r=r, c=c, br=br, bc=bc, k=int(len(bcol_hit)),
    )


def bcsr_to_dense(m: BCSR) -> torch.Tensor:
    """Round trip back to dense float32 on ``m``'s device."""
    row_start, col_idx = _host(m.b_row_start), _host(m.b_col_idx)
    vals = _host(m.b_values)
    w = np.zeros((m.rows, m.cols), dtype=np.float32)
    block_rows = np.repeat(np.arange(m.br), np.diff(row_start))
    for bi in range(m.k):
        i0, j0 = block_rows[bi] * m.r, int(col_idx[bi]) * m.c
        w[i0:i0 + m.r, j0:j0 + m.c] = vals[bi]
    return torch.from_numpy(w).to(m.device)


def bcsr_block_rows(m: BCSR) -> torch.Tensor:
    """int32[k] block row of every stored block (the expanded form of
    ``b_row_start``), on ``m``'s device."""
    e = torch.arange(m.k, dtype=torch.int32, device=m.b_row_start.device)
    return (torch.searchsorted(m.b_row_start, e, right=True) - 1).to(torch.int32)
