"""TCSC — Ternary Compressed Sparse Column, as a dataclass of tensors
(counterpart of smmb_tpu/formats/tcsc.py).

Two independent CSC index planes share the column axis, one for +1 entries
and one for -1 entries, with no value array: values are implicit ±1, which
makes the SpMM inner loop multiplication-free.

    col_start_pos : int32[cols + 1]   CSC column pointers, +1 plane
    col_start_neg : int32[cols + 1]   CSC column pointers, -1 plane
    row_index_pos : int32[n_pos]      row indices of +1 entries (column-major)
    row_index_neg : int32[n_neg]      row indices of -1 entries (column-major)

Construction is a numpy scan on the host with exact ±1.0 compares (the
arrays are bitwise JAX's for the same input); only then are the arrays
placed on ``device`` (None = the CUDA card).

``TCSCPadded`` is the static-shape layout: per-column index rows padded to
a multiple of 8 with the sentinel ``rows``, which points at a zero row
appended to the activation panel, so padded gathers add 0 with no masking.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smmb_tpu_torch.utils.device import resolve_device
from smmb_tpu_torch.utils.shapes import round_up


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dense_np(w) -> np.ndarray:
    """A numpy array or a tensor → float32 numpy (host)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class TCSC:
    """TCSC matrix on one device (see the module docstring for the layout)."""

    col_start_pos: torch.Tensor  # int32[cols + 1]
    col_start_neg: torch.Tensor  # int32[cols + 1]
    row_index_pos: torch.Tensor  # int32[n_pos]
    row_index_neg: torch.Tensor  # int32[n_neg]
    rows: int
    cols: int
    n_pos: int
    n_neg: int

    @property
    def shape(self):
        return (self.rows, self.cols)

    @property
    def nnz(self) -> int:
        return self.n_pos + self.n_neg

    @property
    def density(self) -> float:
        return self.nnz / float(self.rows * self.cols)

    @property
    def device(self) -> torch.device:
        return self.col_start_pos.device

    def index_bytes(self) -> int:
        """Bytes of index-plane traffic a kernel must read from device memory."""
        return 4 * (2 * (self.cols + 1) + self.n_pos + self.n_neg)


def _plane_from_dense(w: np.ndarray, value: float):
    """Column-major scan (column outer, row inner) for entries exactly equal
    to ``value``."""
    cols_hit, rows_hit = np.nonzero(w.T == value)  # sorted by (col, row)
    counts = np.bincount(cols_hit, minlength=w.shape[1])
    col_start = np.zeros(w.shape[1] + 1, dtype=np.int32)
    np.cumsum(counts, out=col_start[1:])
    return col_start, rows_hit.astype(np.int32)


def tcsc_from_dense(w, device=None) -> TCSC:
    """Dense (rows × cols) ternary matrix → TCSC on ``device``.

    Exact float compares against ±1.0: anything not exactly ±1 is zero.
    """
    dev = resolve_device(device)
    w = _dense_np(w)
    if w.ndim != 2:
        raise ValueError(f"expected 2D matrix, got shape {w.shape}")
    rows, cols = w.shape
    csp, rip = _plane_from_dense(w, 1.0)
    csn, rin = _plane_from_dense(w, -1.0)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return TCSC(
        col_start_pos=put(csp), col_start_neg=put(csn),
        row_index_pos=put(rip), row_index_neg=put(rin),
        rows=rows, cols=cols, n_pos=int(len(rip)), n_neg=int(len(rin)),
    )


def tcsc_to_dense(t: TCSC) -> torch.Tensor:
    """Round trip back to a dense float32 matrix on ``t``'s device."""
    csp, csn = _host(t.col_start_pos), _host(t.col_start_neg)
    rip, rin = _host(t.row_index_pos), _host(t.row_index_neg)
    w = np.zeros((t.rows, t.cols), dtype=np.float32)
    w[rip, np.repeat(np.arange(t.cols), np.diff(csp))] = 1.0
    w[rin, np.repeat(np.arange(t.cols), np.diff(csn))] = -1.0
    return torch.from_numpy(w).to(t.device)


@dataclasses.dataclass(frozen=True)
class TCSCPadded:
    """Static-shape per-column index planes.

    ``idx_pos[j, :cnt_pos[j]]`` are the +1 row indices of column j; entries
    at and beyond ``cnt_pos[j]`` equal ``rows``, the sentinel that points at
    a zero row appended to the activation panel.
    """

    idx_pos: torch.Tensor  # int32[cols, pad_pos]
    idx_neg: torch.Tensor  # int32[cols, pad_neg]
    cnt_pos: torch.Tensor  # int32[cols]
    cnt_neg: torch.Tensor  # int32[cols]
    rows: int
    cols: int
    pad_pos: int
    pad_neg: int


def tcsc_pad_columns(t: TCSC, multiple: int = 8) -> TCSCPadded:
    """TCSC → padded per-column index matrices on ``t``'s device (a host
    transform)."""
    out = {}
    for name, cs, ri in (
        ("pos", _host(t.col_start_pos), _host(t.row_index_pos)),
        ("neg", _host(t.col_start_neg), _host(t.row_index_neg)),
    ):
        counts = np.diff(cs)
        pad = round_up(max(int(counts.max()) if len(counts) else 0, 1), multiple)
        idx = np.full((t.cols, pad), t.rows, dtype=np.int32)  # sentinel = rows
        cols_rep = np.repeat(np.arange(t.cols), counts)
        offsets = np.arange(len(ri)) - np.repeat(cs[:-1], counts)
        idx[cols_rep, offsets] = ri
        out[name] = (idx, counts.astype(np.int32), pad)
    put = lambda a: torch.from_numpy(a).to(t.device)  # noqa: E731
    return TCSCPadded(
        idx_pos=put(out["pos"][0]), idx_neg=put(out["neg"][0]),
        cnt_pos=put(out["pos"][1]), cnt_neg=put(out["neg"][1]),
        rows=t.rows, cols=t.cols, pad_pos=out["pos"][2], pad_neg=out["neg"][2],
    )
