"""LoRA adapters over a frozen 2-bit ternary LM (counterpart of
smmb_tpu/models/lora.py).

Fine-tuning must not touch the packed planes, so each adapted projection
serves ``y = packed_spmm(x, W_2bit) + scale·((x A) B)`` with thin f32
A (d_in, r) and B (r, d_out). Adapters attach into the packed tree as
``<name>_lora = (A, B, scale)`` entries (``models/attention._proj`` and
``models/transformer._mlp_half`` add their residuals), so every
single-device serving entry point (forward, prefill, chunked prefill,
decode, generate, beam search, speculative decoding) serves an adapted
model unchanged. The fused gates keep adapted layers off B3, B5 and B6;
the base stays on B1.

Training differentiates only the adapters: the forward is
``lm_forward(use_kernel=False)`` (the plain packed products, the kernel's
math, differentiable in x) and the packed base is a constant. B starts at
zero, so an untrained adapter changes nothing.
"""

from __future__ import annotations

import math

import torch

from smmb_tpu_torch.models.lm import TernaryLMConfig, lm_forward
from smmb_tpu_torch.models.train import make_adam

# adapter targets: the attention projections and the MLP halves of a block
_ATTN_TARGETS = ("wq", "wk", "wv", "wo")
_MLP_TARGETS = ("w_up", "w_down")


def _dims(cfg: TernaryLMConfig, name: str) -> tuple[int, int]:
    d, ff = cfg.d_model, cfg.d_ff
    attn = cfg.blocks[0].attn  # every layer's widths are the same
    qd, kv = attn.q_dim, attn.kv_dim
    return {"wq": (d, qd), "wk": (d, kv), "wv": (d, kv), "wo": (qd, d),
            "w_up": (d, ff), "w_down": (ff, d)}[name]


def init_lora_lm(gen: torch.Generator, cfg: TernaryLMConfig, rank: int = 8,
                 targets: tuple = ("wq", "wv")) -> list:
    """Per-block adapters ``[{name: (A, B)}, ...]`` on ``gen``'s device:
    A ~ N(0, 1/rank), B = 0, so attaching them is an exact no-op until they
    are trained. Targets: any of wq/wk/wv/wo/w_up/w_down (default wq, wv,
    the original LoRA recipe)."""
    for t in targets:
        if t not in _ATTN_TARGETS + _MLP_TARGETS:
            raise ValueError(f"unknown LoRA target {t!r}")
    blocks = []
    for _ in range(cfg.n_layers):
        block = {}
        for name in targets:
            din, dout = _dims(cfg, name)
            a = torch.randn((din, rank), generator=gen, device=gen.device) / math.sqrt(rank)
            block[name] = (a, torch.zeros((rank, dout), device=gen.device))
        blocks.append(block)
    return blocks


def attach_lora(packed: dict, adapters: list, alpha: float = 16.0,
                rank: int | None = None) -> dict:
    """The packed LM tree with the adapters attached (a new tree; the input
    is untouched). The residual's scale is ``alpha/rank`` (rank: A's width
    unless given), an f32 scalar as in JAX."""
    if len(adapters) != len(packed["blocks"]):
        raise ValueError(f"{len(adapters)} adapter blocks vs "
                         f"{len(packed['blocks'])} model blocks")
    blocks = []
    for blk, ad in zip(packed["blocks"], adapters):
        nb = dict(blk)
        for name, (a, b) in ad.items():
            r = rank if rank is not None else a.shape[1]
            entry = (a, b, torch.tensor(alpha / r, dtype=torch.float32, device=a.device))
            if name in _ATTN_TARGETS:
                nb["attn"] = {**nb["attn"], name + "_lora": entry}
            else:
                nb[name + "_lora"] = entry
        blocks.append(nb)
    return {**packed, "blocks": blocks}


def make_lora_train_step(packed: dict, cfg: TernaryLMConfig,
                         learning_rate: float = 1e-3, alpha: float = 16.0):
    """(init_opt, train_step) training only the adapters on next-token
    cross-entropy; the packed base is a frozen constant.

    ``init_opt(adapters)`` returns the ``torch.optim.Adam`` (optax's
    defaults) over the adapter tensors, which it marks as requiring grad;
    ``train_step(adapters, opt_state, tokens) -> (adapters, opt_state,
    loss)`` updates them in place and returns the loss before the update."""

    def loss_fn(adapters, tokens):
        logits = lm_forward(attach_lora(packed, adapters, alpha=alpha), tokens, cfg,
                            use_kernel=False)
        return torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))

    def init_opt(adapters):
        return make_adam(adapters, learning_rate)

    def train_step(adapters, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(adapters, tokens.long())
        loss.backward()
        opt_state.step()
        return adapters, opt_state, loss.detach()

    return init_opt, train_step
