"""Reference-semantics sparse ops in plain PyTorch
(counterpart of smmb_tpu/ops/spmm.py).

- TCSC: ``y = B[n] + Σ X[m, idx_pos] − Σ X[m, idx_neg]`` is a gather of
  rows of Xᵀ by row index and a sum per column (``index_add_`` with column
  ids recovered from the CSC pointers), the -1 plane subtracted from the +1
  plane.
- BCSR: a batched (k, M, r)×(k, r, c) product in full f32 (TF32 off), then
  a sum into block columns.
- PReLU is applied after the whole sum. The reference's BCSR PReLU variant
  applied it per partial update, which is not PReLU of the product; neither
  package copies that.

These are plain ops, not kernels: none of them is a Pallas kernel in JAX.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.formats.bcsr import BCSR, bcsr_block_rows
from smmb_tpu_torch.formats.packed import TernaryPacked, decode_words
from smmb_tpu_torch.formats.tcsc import TCSC, TCSCPadded
from smmb_tpu_torch.ops.dense import full_f32_matmul, prelu


def _segment_ids(col_start: torch.Tensor, n_elem: int) -> torch.Tensor:
    """Column id of every stored element from CSC pointers: element e
    belongs to column j iff col_start[j] <= e < col_start[j + 1]."""
    e = torch.arange(n_elem, dtype=col_start.dtype, device=col_start.device)
    return torch.searchsorted(col_start, e, right=True) - 1


def tcsc_spmm(x: torch.Tensor, w: TCSC, b: torch.Tensor | None = None) -> torch.Tensor:
    """TCSC SpMM: ``Y = X·W + B`` with multiplication-free accumulation."""
    xt = x.t()  # (K, M): row gathers along the contraction axis

    def plane(row_index, col_start, n_elem):
        acc = torch.zeros((w.cols, x.shape[0]), dtype=x.dtype, device=x.device)
        if n_elem == 0:
            return acc
        g = xt.index_select(0, row_index.long())  # (n_elem, M)
        return acc.index_add_(0, _segment_ids(col_start, n_elem), g)

    pos = plane(w.row_index_pos, w.col_start_pos, w.n_pos)
    neg = plane(w.row_index_neg, w.col_start_neg, w.n_neg)
    y = (pos - neg).t()
    if b is not None:
        y = y + b
    return y


def tcsc_spmm_padded(
    x: torch.Tensor, w: TCSCPadded, b: torch.Tensor | None = None
) -> torch.Tensor:
    """TCSC SpMM over the static-shape padded layout: padded entries index
    the appended zero row, so no masking is needed."""
    m = x.shape[0]
    xe = torch.cat([x.t(), torch.zeros((1, m), dtype=x.dtype, device=x.device)])
    pos = xe[w.idx_pos.long()].sum(dim=1)  # (cols, M)
    neg = xe[w.idx_neg.long()].sum(dim=1)
    y = (pos - neg).t()
    if b is not None:
        y = y + b
    return y


def tcsc_spmm_prelu(
    x: torch.Tensor, w: TCSC, b: torch.Tensor | None, alpha: float
) -> torch.Tensor:
    """TCSC SpMM + PReLU: the reference's three PReLU variants (basic,
    separate, on-the-go) agree mathematically and are this one op."""
    return prelu(tcsc_spmm(x, w, b), alpha)


def packed_spmm_ref(
    x: torch.Tensor,
    w: TernaryPacked,
    b: torch.Tensor | None = None,
    alpha: float | None = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """2-bit packed ternary SpMM via full decompress + one product
    (counterpart of ``packed_spmm_jnp``).

    The un-tiled semantics of the kernel: X is cast to ``dtype`` (f32 or
    bf16), W decodes exactly, the product accumulates in f32 (TF32 off), and
    bias and PReLU follow. The result has ``x``'s dtype; leading batch dims
    of a >2-D ``x`` are kept.
    """
    if x.dim() > 2:
        lead = x.shape[:-1]
        y = packed_spmm_ref(x.reshape(-1, x.shape[-1]), w, b, alpha, dtype)
        return y.reshape(*lead, y.shape[-1])
    k = x.shape[-1]
    wd = decode_words(w.data, torch.float32)[:k]
    y = full_f32_matmul(x.to(dtype), wd)
    if b is not None:
        y = y + b
    if alpha is not None:
        y = prelu(y, alpha)
    return y.to(x.dtype)


def bcsr_spmm(x: torch.Tensor, w: BCSR, b: torch.Tensor | None = None) -> torch.Tensor:
    """BCSR SpMM: ``Y[:, bc*c:(bc+1)*c] += X[:, br*r:(br+1)*r] @ block``.

    Gathers the X panel of every stored block, one batched (k, M, r)×(k, r,
    c) product in f32, then sums the (k, M, c) partials into their block
    columns.
    """
    m = x.shape[0]
    if w.k == 0:
        y = torch.zeros((m, w.cols), dtype=x.dtype, device=x.device)
        return y if b is None else y + b
    xp = x.t().reshape(w.br, w.r, m)  # panels by block row
    xg = xp.index_select(0, bcsr_block_rows(w).long())  # (k, r, M)
    part = full_f32_matmul(xg.transpose(1, 2), w.b_values)  # (k, M, c)
    acc = torch.zeros((w.bc, m, w.c), dtype=torch.float32, device=x.device)
    acc.index_add_(0, w.b_col_idx.long(), part)
    y = acc.permute(1, 0, 2).reshape(m, w.cols).to(x.dtype)
    if b is not None:
        y = y + b
    return y


def bcsr_spmm_prelu(
    x: torch.Tensor, w: BCSR, b: torch.Tensor | None, alpha: float
) -> torch.Tensor:
    """BCSR SpMM + PReLU after the whole sum."""
    return prelu(bcsr_spmm(x, w, b), alpha)
