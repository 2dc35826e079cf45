"""``PackedTernaryDense`` — the frozen serving layer as an ``nn.Module``
(counterpart of smmb_tpu/nn.py:60-117).

The training layer ``TernaryDense`` belongs to the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from smmb_tpu_torch.formats.packed import GROUP_ROWS, VALUES_PER_BYTE, TernaryPacked
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils.device import resolve_device
from smmb_tpu_torch.utils.shapes import round_up


class PackedTernaryDense(nn.Module):
    """``y = prelu((x · scale) @ W + bias, alpha)`` over 2-bit packed W.

    Buffers: ``packed_kernel`` (int8 packed planes, zeros until loaded),
    ``kernel_scale`` (scalar f32, ones) and ``bias`` (f32, zeros; absent
    when ``use_bias=False``). The scale multiplies the ±1 weights and is
    folded into x before the product (PReLU commutes with positive scaling).
    ``use_kernel=False`` runs the plain decode-then-matmul version.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        use_bias: bool = True,
        alpha: float | None = 0.2,
        compute_dtype=torch.bfloat16,
        use_kernel: bool = True,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.features = features
        self.alpha = alpha
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        packed_rows = round_up(max(in_features, 1), GROUP_ROWS) // VALUES_PER_BYTE
        self.register_buffer(
            "packed_kernel",
            torch.zeros((packed_rows, features), dtype=torch.int8, device=dev),
        )
        self.register_buffer(
            "kernel_scale", torch.ones((), dtype=torch.float32, device=dev)
        )
        self.register_buffer(
            "bias",
            torch.zeros((features,), dtype=torch.float32, device=dev)
            if use_bias
            else None,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = TernaryPacked(
            self.packed_kernel, self.in_features, self.features, nnz=-1
        )
        xs = x * self.kernel_scale
        if self.use_kernel:
            return packed_spmm(
                xs, w, self.bias, self.alpha, compute_dtype=self.compute_dtype
            )
        return packed_spmm_ref(xs, w, self.bias, self.alpha, dtype=self.compute_dtype)
