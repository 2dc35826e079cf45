"""Sharded packed-ternary SpMM over the process mesh (counterpart of
smmb_tpu/parallel/sharded.py).

Two weight partitionings, composing into the Megatron-style MLP pairing
(models/mlp.py):

* **column** — each model rank owns a contiguous slice of the output
  columns N. X is replicated over the model axis (batch-sharded over
  "data"); the forward needs no collective, and each rank's output is its
  own column panel.
* **row** — each model rank owns a slice of the contraction axis K (whole
  512-row packed groups). Ranks compute partial products over their K range
  and sum them with one model-axis ``all_reduce``; the bias and the PReLU
  follow the sum.

Each rank's body is the single-rank B1 wrapper (kernels/packed_spmm.py) on
the rank's shard, or its plain version with ``use_kernel=False``.

As everywhere in the port's parallel layer, tensors in and out are the
rank's own blocks: x is the rank's batch rows (``mesh.local_rows``), and
for the row path its K chunk (``mesh.local_cols``); the column path returns
the rank's column panel, which a caller that needs it whole gathers
(``mesh.all_gather``), as JAX's callers do. The bias is passed whole and
each rank takes its slice. ``shard_packed_*`` return the rank's shard of
the planes, a ``TernaryPacked`` on the mesh's device.

Granularity, validated as in JAX: column shards are 128-column aligned,
row shards hold whole 512-row packed groups (``GROUP_ROWS``).
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.formats.packed import GROUP_ROWS, VALUES_PER_BYTE, TernaryPacked
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.ops.dense import prelu
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_reduce


def _model_size(mesh: Mesh) -> int:
    return mesh.axis_size(MODEL_AXIS)


def shard_packed_columns(w: TernaryPacked, mesh: Mesh) -> TernaryPacked:
    """The rank's column shard of the packed planes: a contiguous copy of
    its N/model columns, on the mesh's device."""
    nshard = _model_size(mesh)
    if w.cols % (nshard * 128):
        raise ValueError(f"cols={w.cols} must be a multiple of 128×model={nshard * 128}")
    n = w.cols // nshard
    j = mesh.index(MODEL_AXIS)
    data = w.data[:, j * n:(j + 1) * n].to(mesh.device).contiguous()
    return TernaryPacked(data=data, rows=w.rows, cols=n, nnz=-1)


def shard_packed_rows(w: TernaryPacked, mesh: Mesh) -> TernaryPacked:
    """The rank's row (K) shard of the packed planes: its K/model logical
    rows, whole packed groups, on the mesh's device."""
    nshard = _model_size(mesh)
    if w.rows != w.padded_rows or (w.rows // GROUP_ROWS) % nshard:
        raise ValueError(
            f"K={w.rows} must be an exact multiple of model={nshard} packed "
            f"groups ({GROUP_ROWS} rows each) — row shards must align with "
            "the K-chunks of the sharded activations")
    pr = w.packed_rows // nshard
    j = mesh.index(MODEL_AXIS)
    data = w.data[j * pr:(j + 1) * pr].to(mesh.device).contiguous()
    return TernaryPacked(data=data, rows=pr * VALUES_PER_BYTE, cols=w.cols, nnz=-1)


def _local_spmm(x, w_local, b, alpha, compute_dtype, use_kernel):
    """Per-rank body: the single-rank packed SpMM on the local shard."""
    if use_kernel:
        return packed_spmm(x, w_local, b, alpha, compute_dtype=compute_dtype)
    return packed_spmm_ref(x, w_local, b, alpha, dtype=compute_dtype)


def _partial(x, w_local, compute_dtype, use_kernel):
    """A rank's partial product over its K range, in f32 whatever x's dtype
    (a bf16 x is widened exactly; the kernel casts it back to bf16), so the
    sum over ranks rounds once, at the end, as the unsharded call does."""
    return _local_spmm(x.to(torch.float32), w_local, None, None, compute_dtype, use_kernel)


def _epilogue(y, b, alpha, dtype):
    if b is not None:
        y = y + b.to(torch.float32)
    if alpha is not None:
        y = prelu(y, alpha)
    return y.to(dtype)


def _bias_cols(b, mesh: Mesh, n_local: int):
    """The rank's slice of a whole (N,) bias of a column-sharded layer."""
    if b is None:
        return None
    j = mesh.index(MODEL_AXIS)
    return b[j * n_local:(j + 1) * n_local].to(mesh.device)


def sharded_spmm_column(x: torch.Tensor, w: TernaryPacked, b: torch.Tensor | None, *,
                        mesh: Mesh, alpha: float | None = None,
                        compute_dtype=torch.float32, use_kernel: bool = True) -> torch.Tensor:
    """Column-parallel ``Y = prelu(X·W + B)``: x (M_local, K), ``w`` the
    rank's column shard; returns the rank's (M_local, N/model) panel. No
    forward collective."""
    return _local_spmm(x, w, _bias_cols(b, mesh, w.cols), alpha, compute_dtype, use_kernel)


def sharded_spmm_row(x: torch.Tensor, w: TernaryPacked, b: torch.Tensor | None, *,
                     mesh: Mesh, alpha: float | None = None,
                     compute_dtype=torch.float32, use_kernel: bool = True) -> torch.Tensor:
    """Row(K)-parallel SpMM: x (M_local, K/model) is the rank's K chunk (as
    a preceding column-parallel layer leaves it), ``w`` its row shard; the
    partials are summed by one model-axis ``all_reduce`` and the bias and
    PReLU applied after the sum. Returns (M_local, N), replicated over the
    model axis."""
    if x.shape[-1] != w.rows:
        raise ValueError(f"x K chunk {x.shape[-1]} != row shard {w.rows}")
    part = _partial(x, w, compute_dtype, use_kernel)
    y = all_reduce(part, mesh, MODEL_AXIS)
    return _epilogue(y, None if b is None else b.to(mesh.device), alpha, x.dtype)
