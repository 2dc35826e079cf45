"""Column-sharded BCSR SpMM over the process mesh (counterpart of
smmb_tpu/parallel/bcsr_sharded.py).

Each model rank owns a contiguous range of block columns (the BCSR analog
of the packed column partitioning) and runs the single-rank B2 wrapper
(kernels/bcsr_spmm.py) on its local block list. Like
``sharded_spmm_column`` the forward needs no collective; each rank returns
its column panel.

JAX's padding of the ragged block lists is kept: every rank's list is
padded to the fleet-wide largest count ``kmax`` with zero-valued blocks
appended to the rank's last occupied block column, so they extend that
column's run (the epilogue still runs once, after the run's last block, and
the dummies add exact zeros). A rank with no real block aims its dummies at
its last block column and marks that column occupied, so the column's
output is bias + 0 with the PReLU applied once: the activated bias, exact
for any alpha. Every rank then walks the same number of blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smmb_tpu_torch.kernels.bcsr_spmm import BCSRPrepared, bcsr_spmm_kernel, col_starts
from smmb_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from smmb_tpu_torch.parallel.sharded import _bias_cols


@dataclasses.dataclass(frozen=True)
class BCSRColumnShards:
    """The rank's block-column shard: ``local`` is a kernel-ready
    ``BCSRPrepared`` of ``cols // nshard`` columns with shard-local
    block-column indices and ``kmax`` blocks (padded, see the module
    docstring); ``rows``/``cols`` are the whole matrix's."""

    local: BCSRPrepared
    rows: int
    cols: int
    r: int
    c: int
    kmax: int
    nshard: int


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def shard_bcsr_columns(prep: BCSRPrepared, mesh: Mesh) -> BCSRColumnShards:
    """Partition a prepared BCSR by block-column range over the model axis
    (host side): split the column-major block list at shard boundaries,
    rebase the column indices, pad to the largest count and place the
    rank's shard on the mesh's device."""
    nshard = mesh.axis_size(MODEL_AXIS)
    if prep.cols % (nshard * prep.c):
        raise ValueError(f"cols={prep.cols} must be a multiple of c×model="
                         f"{nshard * prep.c} for block-column sharding")
    cols_local = prep.cols // nshard
    bc_local = cols_local // prep.c
    rows_np = _host(prep.blk_row)[:-1]
    cols_np = _host(prep.blk_col)[:-1]
    shard_of = cols_np // bc_local
    counts = np.bincount(shard_of, minlength=nshard)
    kmax = max(int(counts.max()) if len(cols_np) else 0, 1)

    s = mesh.index(MODEL_AXIS)
    sel = shard_of == s
    ks = int(counts[s])
    local_cols = cols_np[sel] - s * bc_local
    has = _host(prep.col_has_blocks).reshape(nshard, cols_local)[s].copy()
    # dummies extend the last occupied column's run; an empty shard aims
    # them at its last block column and marks it occupied
    pad_col = int(local_cols[-1]) if ks else bc_local - 1
    if ks < kmax:
        has[pad_col * prep.c:(pad_col + 1) * prep.c] = 1.0
    br = np.zeros(kmax + 1, np.int32)
    bc = np.full(kmax + 1, -1, np.int32)
    br[:ks] = rows_np[sel]
    bc[:ks] = local_cols
    bc[ks:kmax] = pad_col
    vals = _host(prep.values)
    vv = np.zeros((kmax,) + vals.shape[1:], np.int8)
    vv[:ks] = vals[sel]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

    local = BCSRPrepared(
        blk_row=put(br), blk_col=put(bc), values=put(vv), col_has_blocks=put(has),
        col_start=put(col_starts(bc, kmax, bc_local)),
        rows=prep.rows, cols=cols_local, r=prep.r, c=prep.c, k=kmax)
    return BCSRColumnShards(local=local, rows=prep.rows, cols=prep.cols, r=prep.r,
                            c=prep.c, kmax=kmax, nshard=nshard)


def sharded_bcsr_spmm(x: torch.Tensor, w: BCSRColumnShards, b: torch.Tensor | None = None,
                      *, mesh: Mesh, alpha: float | None = None, block_m: int = 256,
                      x_resident: bool | None = None) -> torch.Tensor:
    """Block-column-parallel ``Y = prelu(X @ W + B, alpha)``: x (M_local, K)
    replicated over the model axis; returns the rank's (M_local, N/model)
    panel, no forward collective. ``block_m`` and ``x_resident`` pass to
    the B2 wrapper (kept for JAX's signature)."""
    return bcsr_spmm_kernel(x, w.local, _bias_cols(b, mesh, w.local.cols), alpha,
                            block_m=block_m, x_resident=x_resident)
