"""Ternarization for serving (counterpart of smmb_tpu/models/train.py:25-49).

Absmean rule: ``W_q = clip(round(W / mean|W|), -1, 1)``, with the scale kept
beside the packed planes so the packed format stays value-free. Only what
``pack_mlp(quantize=True)`` needs is here; ``qat_forward`` and the training
step belong to the training slice of the port.
"""

from __future__ import annotations

import torch


class _TernarizeSTE(torch.autograd.Function):
    """Absmean ternarization; the backward passes the gradient straight
    through (d(quantize)/dw ≈ I)."""

    @staticmethod
    def forward(ctx, w):
        scale = w.abs().mean() + 1e-8
        return torch.clamp(torch.round(w / scale), -1.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        return g


def ternarize_ste(w: torch.Tensor) -> torch.Tensor:
    """The *unscaled* ternary matrix in {-1, 0, +1} (float), straight-through
    gradients; the scale is ``absmean_scale(w)``."""
    return _TernarizeSTE.apply(w)


def absmean_scale(w: torch.Tensor) -> torch.Tensor:
    return w.abs().mean() + 1e-8
