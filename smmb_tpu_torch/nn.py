"""Ternary layers as ``nn.Module``s (counterpart of smmb_tpu/nn.py):

- ``TernaryDense``: the QAT layer, an f32 master kernel ternarized by the
  STE on every forward (models/train.py's recipe), differentiable;
- ``PackedTernaryDense``: the frozen serving layer over 2-bit packed planes
  (B1, ``packed_spmm``);
- ``convert_to_packed``: a ``TernaryDense`` state dict → one that loads into
  ``PackedTernaryDense``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from smmb_tpu_torch.formats.packed import (
    GROUP_ROWS,
    VALUES_PER_BYTE,
    TernaryPacked,
    pack_ternary_device,
)
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.models.train import absmean_scale, qat_linear, ternarize_ste
from smmb_tpu_torch.ops.dense import prelu
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.device import resolve_device
from smmb_tpu_torch.utils.shapes import round_up

# flax's lecun_normal: a normal truncated at ±2 standard deviations, its
# scale divided by the truncated normal's own deviation (0.8796...)
_TRUNC_STD = 0.87962566103423978


class TernaryDense(nn.Module):
    """QAT layer: ``y = act(x @ (s·T(W)) + b)``, cast to x's dtype.

    ``kernel`` (in_features, features) is the f32 master, LeCun-normal from
    ``generator`` (a generator on ``device``; None = seed 0); ``T`` is the
    absmean STE ternarization and ``s`` its scale, so the effective weight
    is exactly what the 2-bit format serves. ``bias`` starts at zero;
    ``alpha`` is the PReLU slope (None = linear).
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 alpha: float | None = 0.2, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else rng.make_generator(0, dev)
        std = math.sqrt(1.0 / in_features) / _TRUNC_STD
        kernel = torch.empty((in_features, features), dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        self.kernel = nn.Parameter(kernel)
        self.bias = (nn.Parameter(torch.zeros((features,), dtype=torch.float32, device=dev))
                     if use_bias else None)
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = qat_linear(x, self.kernel, self.bias)
        if self.alpha is not None:
            y = prelu(y, self.alpha)
        return y.to(x.dtype)


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


def convert_to_packed(tree: dict) -> dict:
    """``TernaryDense`` parameters → ``PackedTernaryDense`` parameters.

    Walks a state-dict tree (nested dicts, or a flat ``state_dict`` with
    dotted keys): every 2-D ``kernel`` becomes ``packed_kernel`` (the int8
    planes of ``ternarize_ste(kernel)``) and ``kernel_scale`` (its absmean);
    every other entry (biases, nesting) is kept.
    """
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out[key] = convert_to_packed(v)
            continue
        prefix = key[: -len("kernel")]
        if (key == "kernel" or key.endswith(".kernel")) and getattr(v, "ndim", 0) == 2:
            with torch.no_grad():
                out[prefix + "packed_kernel"] = pack_ternary_device(ternarize_ste(v)).data
                out[prefix + "kernel_scale"] = absmean_scale(v).to(torch.float32)
        else:
            out[key] = v
    return out
