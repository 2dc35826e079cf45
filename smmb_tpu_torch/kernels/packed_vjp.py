"""Differentiable packed SpMM: the frozen-backbone fine-tuning path
(counterpart of smmb_tpu/kernels/packed_vjp.py).

Serving weights are 2-bit and frozen, but adapters, probes or biases on top
of a frozen ternary backbone need gradients through the packed layer with
respect to its input. The backward product ``dx = g @ Wᵀ`` is itself a
ternary SpMM with the transposed matrix, so it runs through the same kernel,
B1 (``packed_spmm``, ``csrc/packed_spmm.cu``), against a second plane set
packed from Wᵀ: the layer launches B1 forward on W and backward on Wᵀ, with
bias and PReLU off. It has no kernel of its own, as JAX has no backward
Pallas kernel.

Usage::

    w_p, wt_p = pack_with_transpose(w_dense)
    layer = make_packed_linear(w_p, wt_p, alpha=0.2)
    y = layer(x, b)            # differentiable w.r.t. x and b

The PReLU's gradient is taken inside the backward, with the mask from the
forward output (``y > 0`` ⇔ pre-activation > 0 for any alpha ≥ 0).
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.formats.packed import TernaryPacked, pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain


def pack_with_transpose(w_dense: torch.Tensor) -> tuple[TernaryPacked, TernaryPacked]:
    """Pack a ternary matrix and its transpose, on its own device."""
    return pack_ternary_device(w_dense), pack_ternary_device(w_dense.t())


class _PackedLinear(torch.autograd.Function):
    """``prelu(x @ W + b, alpha)`` with B1 forward on W and backward on Wᵀ."""

    @staticmethod
    def forward(ctx, x, b, spmm, w, w_t, alpha, compute_dtype):
        y = spmm(x, w, b, alpha, compute_dtype=compute_dtype)
        ctx.save_for_backward(y)
        ctx.spmm, ctx.w_t, ctx.alpha, ctx.compute_dtype = spmm, w_t, alpha, compute_dtype
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        if ctx.alpha is not None:
            # d prelu(z)/dz = 1 where z > 0 else alpha; y > 0 ⇔ z > 0 for α ≥ 0
            g = torch.where(y > 0, g, ctx.alpha * g)
        g = g.to(y.dtype)  # JAX's cast: db sums the cast g, in y's dtype
        dx = db = None
        if ctx.needs_input_grad[0]:
            dx = ctx.spmm(g, ctx.w_t, None, None, compute_dtype=ctx.compute_dtype)
        if ctx.needs_input_grad[1]:
            db = g.reshape(-1, g.shape[-1]).sum(dim=0)
        return dx, db, None, None, None, None, None


def make_packed_linear(
    w: TernaryPacked,
    w_t: TernaryPacked,
    alpha: float | None = None,
    compute_dtype=torch.bfloat16,
    use_kernel: bool | None = None,
):
    """Build ``fn(x, b) -> prelu(x @ W + b, alpha)``, differentiable in x and
    b; ``w_t`` must be the packed transpose of ``w``.

    ``use_kernel`` keeps JAX's keyword; None and True are the same:
    ``packed_spmm``, which launches B1 on CUDA tensors and runs its plain
    version on CPU tensors. Only False changes anything: the plain version
    on any device (for tests). When x needs no gradient, the backward skips
    its B1 launch.
    """
    if (w.rows, w.cols) != (w_t.cols, w_t.rows):
        raise ValueError(f"w_t shape {w_t.shape} is not the transpose of w {w.shape}")
    if alpha is not None and alpha < 0:
        # the backward mask comes from the forward OUTPUT (y > 0), which only
        # equals the pre-activation's sign for alpha >= 0
        raise ValueError(f"make_packed_linear requires alpha >= 0, got {alpha}")
    spmm = packed_spmm_plain if use_kernel is False else packed_spmm

    def fn(x, b):
        return _PackedLinear.apply(x, b, spmm, w, w_t, alpha, compute_dtype)

    return fn
