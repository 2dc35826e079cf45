"""Collective matmul: the activation all-gather overlapped with the SpMM
(counterpart of smmb_tpu/parallel/overlap.py).

A column-parallel layer fed by feature-sharded activations (a previous
column layer's output) needs all of X. In place of a blocking
``all_gather(x)`` then the SpMM, each rank walks the model-axis ring: it
multiplies the activation chunk it holds by the matching K rows of its
weight shard while the chunk travels on to its neighbour. JAX's
``ppermute`` is a ``batch_isend_irecv`` to the ring neighbours here
(``mesh.ring_shift_start``), issued before the B1 call on the chunk in hand
and waited for after it, so the transfer runs while the card computes. In
a gloo world on the GPU the chunk crosses host memory (mesh.py), and the
transfer still runs on the host while the card computes.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.formats.packed import GROUP_ROWS, VALUES_PER_BYTE, TernaryPacked
from smmb_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, ring_shift_start
from smmb_tpu_torch.parallel.sharded import _bias_cols, _epilogue, _partial


def sharded_spmm_column_overlapped(x: torch.Tensor, w: TernaryPacked,
                                   b: torch.Tensor | None, *, mesh: Mesh,
                                   alpha: float | None = None,
                                   compute_dtype=torch.float32,
                                   use_kernel: bool = True) -> torch.Tensor:
    """Column-parallel SpMM with the ring-overlapped activation all-gather.

    x (M_local, K/model) is the rank's K chunk (rank d holds
    ``x[:, d·K/n:(d+1)·K/n]``), ``w`` its column shard (``w.rows`` = K, a
    multiple of model × 512). Returns the rank's (M_local, N/model) panel,
    like ``sharded_spmm_column``: model − 1 ring rounds and model B1 calls,
    their partials summed in f32 in ring order, then the bias and PReLU.
    """
    nshard = mesh.axis_size(MODEL_AXIS)
    if w.padded_rows != w.rows or w.rows % (nshard * GROUP_ROWS):
        raise ValueError(f"K={w.rows} must be a multiple of {nshard}×{GROUP_ROWS} "
                         "for overlapped column-parallel")
    rows_chunk = w.rows // nshard
    if x.shape[-1] != rows_chunk:
        raise ValueError(f"x K chunk {x.shape[-1]} != K/model = {rows_chunk}")
    packed_chunk = rows_chunk // VALUES_PER_BYTE
    idx = mesh.index(MODEL_AXIS)
    acc = None
    chunk = x
    for s in range(nshard):
        src = (idx - s) % nshard  # owner of the chunk in hand
        w_chunk = TernaryPacked(data=w.data[src * packed_chunk:(src + 1) * packed_chunk],
                                rows=rows_chunk, cols=w.cols, nnz=-1)
        nxt = ring_shift_start(chunk, mesh, MODEL_AXIS) if s < nshard - 1 else None
        part = _partial(chunk, w_chunk, compute_dtype, use_kernel)
        acc = part if acc is None else acc + part
        if nxt is not None:
            chunk = nxt.wait()
    return _epilogue(acc, _bias_cols(b, mesh, w.cols), alpha, x.dtype)
