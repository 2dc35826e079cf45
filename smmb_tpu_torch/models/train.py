"""Quantization-aware training of ternary MLPs (counterpart of
smmb_tpu/models/train.py).

Straight-through-estimator (STE) recipe: f32 master weights, ternarized on
the forward pass with the gradient passed through unchanged, so the trained
masters pack straight into the 2-bit serving format (``pack_mlp(...,
quantize=True)``). Absmean rule: ``W_q = clip(round(W / mean|W|), -1, 1)``,
with the scale kept beside the packed planes so the format stays
value-free.

The training products are dense f32 matmuls (TF32 off, as JAX's f32 dot on
the CPU), outside any kernel, as JAX's ``jnp.dot`` is outside any Pallas
kernel; the packed B1 kernel is the serving twin. ``torch.optim.Adam`` with
optax's defaults stands in for ``optax.adam``.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.ops.dense import full_f32_matmul, prelu


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


def qat_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ (absmean(w) · T(w)) + b`` in f32, differentiable in x, w and b:
    the training twin of one packed projection."""
    y = full_f32_matmul(x, ternarize_ste(w) * absmean_scale(w))
    return y if b is None else y + b


def qat_forward(params: dict, x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Training forward of the ternary MLP: per layer
    ``prelu(x @ (scale · T(W)) + b, alpha)`` on the masters, the serving
    math of models/mlp.py kept differentiable."""
    for w, b in zip(params["w"], params["b"]):
        x = prelu(qat_linear(x, w, b), alpha)
    return x


def param_leaves(tree) -> list:
    """The tensors of a parameter tree (dicts and lists), in a fixed order:
    dict insertion order, then list order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in param_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return []


def make_adam(params, learning_rate: float) -> torch.optim.Adam:
    """Adam with optax's defaults (betas 0.9/0.999, eps 1e-8, no weight
    decay) over every tensor of ``params``, which become leaves that
    require grad. The optimizer is the ``opt_state`` of the train steps."""
    leaves = param_leaves(params)
    for t in leaves:
        if not t.is_leaf:
            raise ValueError("parameters must be leaf tensors (detach them first)")
        t.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(alpha: float = 0.2, learning_rate: float = 1e-3):
    """(init_opt, train_step) for MSE regression on the ternary MLP.

    ``init_opt(params)`` returns the ``opt_state``: a ``torch.optim.Adam``
    over the master tensors of ``params`` (``{"w": [...], "b": [...]}``),
    which it marks as requiring grad. ``train_step(params, opt_state, x, y)
    -> (params, opt_state, loss)`` updates the masters in place and returns
    them, the optimizer, and the batch's loss before the update.
    """

    def init_opt(params):
        return make_adam(params, learning_rate)

    def train_step(params, opt_state, x, y):
        opt_state.zero_grad(set_to_none=True)
        loss = torch.mean((qat_forward(params, x, alpha) - y) ** 2)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_opt, train_step
