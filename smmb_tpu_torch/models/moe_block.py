"""MoE transformer block: attention + routed ternary expert FFN
(counterpart of smmb_tpu/models/moe_block.py).

The dense block of models/transformer.py with the MLP half replaced by the
routed mixture of models/moe.py (Switch / Mixtral). The interface mirrors
transformer.py one for one (init, pack, cache, forward, prefill, extend,
decode step, QAT forward), so ``TernaryLMConfig(n_experts=...)`` swaps the
block kind and every serving entry point of models/lm.py runs over MoE
blocks: everything cache-shaped lives in the attention half.

Routes, as in JAX: the attention half is called on the already-normalized
input (no ``prenorm``), so its Q/K/V are the fused plane through B1, never
B3 or B7, and the MoE half has no fused kernel, so B5 and B6 are never
reached. Each layer launches B1 for its projections and B1g twice for its
experts (``moe.moe_forward``, ``no_drop=True`` when serving, so decode
routes a token as the prefill routes it; the f32 and W2A8 modes keep
2·E B1 launches, on the CPU as on the card). The MoE half returns f32 (JAX's
promotion), so after the first MoE half the residual stream is f32, unless
``residual_f32=False`` rounds it to the stream's dtype before the add.
"""

from __future__ import annotations

import dataclasses

import torch

from smmb_tpu_torch.models.attention import (
    TernaryAttentionConfig,
    attention_decode_step,
    attention_extend,
    attention_forward,
    attention_prefill,
    init_attention,
    init_kv_cache,
    pack_attention,
    qat_attention_forward,
)
from smmb_tpu_torch.models.moe import (
    TernaryMoEConfig,
    init_moe,
    moe_forward,
    pack_moe,
    qat_moe_forward,
)
from smmb_tpu_torch.models.transformer import rmsnorm
from smmb_tpu_torch.utils.spans import BLOCK_ATTN, BLOCK_MOE, span


@dataclasses.dataclass(frozen=True)
class TernaryMoEBlockConfig:
    d_model: int
    n_heads: int
    d_ff: int  # per-expert hidden width
    n_experts: int = 8
    top_k: int = 1
    capacity_factor: float = 1.25
    alpha: float = 0.2
    causal: bool = True
    non_zero: int = 2
    eps: float = 1e-6
    n_kv_heads: int | None = None
    rope: bool = False
    rope_theta: float = 10000.0
    window: int | None = None
    head_dim: int | None = None  # None = d_model // n_heads
    # True: the MoE half's f32 output promotes the residual stream to f32
    # (JAX's promotion); False: it is rounded to the stream's dtype first,
    # so a bf16 stream stays bf16 (and the next attention computes in bf16)
    residual_f32: bool = True

    @property
    def attn(self) -> TernaryAttentionConfig:
        return TernaryAttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads, causal=self.causal,
            non_zero=self.non_zero, n_kv_heads=self.n_kv_heads, rope=self.rope,
            rope_theta=self.rope_theta, window=self.window, head_dim=self.head_dim,
        )

    @property
    def moe(self) -> TernaryMoEConfig:
        return TernaryMoEConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            capacity_factor=self.capacity_factor, alpha=self.alpha,
            non_zero=self.non_zero, top_k=self.top_k,
        )


def init_moe_block(gen: torch.Generator, cfg: TernaryMoEBlockConfig) -> dict:
    """Masters of one MoE block on ``gen``'s device."""
    return {
        "attn": init_attention(gen, cfg.attn),
        "moe": init_moe(gen, cfg.moe),
        "norm1": torch.ones((cfg.d_model,), device=gen.device),
        "norm2": torch.ones((cfg.d_model,), device=gen.device),
    }


def pack_moe_block(params: dict, quantize: bool = False) -> dict:
    return {
        "attn": pack_attention(params["attn"], quantize=quantize),
        "moe": pack_moe(params["moe"], quantize=quantize),
        "norm1": params["norm1"],
        "norm2": params["norm2"],
    }


def init_moe_block_cache(cfg: TernaryMoEBlockConfig, batch: int, max_len: int,
                         dtype=torch.float32, quantized: bool = False,
                         ragged: bool = False, device=None) -> dict:
    """KV cache for the block's attention (see ``attention.init_kv_cache``)."""
    return init_kv_cache(cfg.attn, batch, max_len, dtype, quantized, ragged, device)


def _moe_half(packed, x, cfg, compute_dtype, use_kernel):
    with span(BLOCK_MOE):
        h = rmsnorm(x, packed["norm2"], cfg.eps)
        b, t, d = h.shape
        y = moe_forward(packed["moe"], h.reshape(b * t, d), cfg.moe,
                        compute_dtype=compute_dtype, use_kernel=use_kernel, no_drop=True)
        y = y.reshape(b, t, d)
        return x + (y if cfg.residual_f32 else y.to(x.dtype))


def moe_block_forward(packed: dict, x: torch.Tensor, cfg: TernaryMoEBlockConfig, *,
                      compute_dtype=torch.float32, use_kernel: bool = True,
                      use_flash: bool = False) -> torch.Tensor:
    """Pre-norm MoE block: x + attn(norm(x)), then x + moe(norm(x))."""
    with span(BLOCK_ATTN):
        h = rmsnorm(x, packed["norm1"], cfg.eps)
        x = x + attention_forward(packed["attn"], h, cfg.attn, compute_dtype=compute_dtype,
                                  use_kernel=use_kernel, use_flash=use_flash)
    return _moe_half(packed, x, cfg, compute_dtype, use_kernel)


def moe_block_prefill(packed: dict, x: torch.Tensor, cache: dict,
                      cfg: TernaryMoEBlockConfig, *, compute_dtype=torch.float32,
                      use_kernel: bool = True, use_flash: bool = False, valid=None):
    """Prompt pass: the block forward + the KV-cache fill. Returns (y, cache)."""
    with span(BLOCK_ATTN):
        h = rmsnorm(x, packed["norm1"], cfg.eps)
        att, cache = attention_prefill(packed["attn"], h, cache, cfg.attn,
                                       compute_dtype=compute_dtype, use_kernel=use_kernel,
                                       use_flash=use_flash, valid=valid)
        x = x + att
    return _moe_half(packed, x, cfg, compute_dtype, use_kernel), cache


def moe_block_extend(packed: dict, x: torch.Tensor, cache: dict,
                     cfg: TernaryMoEBlockConfig, *, compute_dtype=torch.float32,
                     use_kernel: bool = True, use_flash: bool = False):
    """A (B, C, D) chunk appended at the cache position. Returns (y, cache)."""
    with span(BLOCK_ATTN):
        h = rmsnorm(x, packed["norm1"], cfg.eps)
        att, cache = attention_extend(packed["attn"], h, cache, cfg.attn,
                                      compute_dtype=compute_dtype, use_kernel=use_kernel,
                                      use_flash=use_flash)
        x = x + att
    return _moe_half(packed, x, cfg, compute_dtype, use_kernel), cache


def moe_block_decode_step(packed: dict, x_t: torch.Tensor, cache: dict,
                          cfg: TernaryMoEBlockConfig, *, compute_dtype=torch.float32,
                          use_kernel: bool = True, use_flash: bool = False):
    """One decode step through the block: x_t (B, 1, d_model)."""
    with span(BLOCK_ATTN):
        h = rmsnorm(x_t, packed["norm1"], cfg.eps)
        att, cache = attention_decode_step(packed["attn"], h, cache, cfg.attn,
                                           compute_dtype=compute_dtype,
                                           use_kernel=use_kernel, use_flash=use_flash)
        x_t = x_t + att
    return _moe_half(packed, x_t, cfg, compute_dtype, use_kernel), cache


def qat_moe_block_forward(params: dict, x: torch.Tensor, cfg: TernaryMoEBlockConfig,
                          attn_chunk: int | None = None):
    """STE training forward; returns (y, load-balance aux loss)."""
    h = rmsnorm(x, params["norm1"], cfg.eps)
    x = x + qat_attention_forward(params["attn"], h, cfg.attn, attn_chunk=attn_chunk)
    h2 = rmsnorm(x, params["norm2"], cfg.eps)
    b, t, d = h2.shape
    y, aux = qat_moe_forward(params["moe"], h2.reshape(b * t, d), cfg.moe)
    return x + y.reshape(b, t, d), aux
