"""Reference-semantics packed SpMM in plain PyTorch
(counterpart of ``packed_spmm_jnp``, smmb_tpu/ops/spmm.py:99-134).

The TCSC and BCSR ops of the JAX module belong to a later slice of the port.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.formats.packed import TernaryPacked, decode_words
from smmb_tpu_torch.ops.dense import full_f32_matmul, prelu


def packed_spmm_ref(
    x: torch.Tensor,
    w: TernaryPacked,
    b: torch.Tensor | None = None,
    alpha: float | None = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """2-bit packed ternary SpMM via full decompress + one product.

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
