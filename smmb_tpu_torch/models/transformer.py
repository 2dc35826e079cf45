"""Ternary transformer block — the serving part (counterpart of
smmb_tpu/models/transformer.py): pre-norm attention + MLP with residuals
and RMSNorm, every matmul weight in the 2-bit packed format.

Routing mirrors JAX. At decode M (≤ 32 rows) the block tail (``wo``,
residual, norm2, MLP) runs as one ``fused_block_tail`` call (B5) and the
pre-attention norm rides the fused QKV call (B3); in a short prefill the
MLP half runs as one ``fused_mlp`` call (B6); otherwise each projection is
one ``packed_spmm`` call (B1). The gates keep JAX's semantic conditions;
their size limits are re-derived from the CUDA kernels' shared memory.
"""

from __future__ import annotations

import dataclasses

import torch

from smmb_tpu_torch.formats.packed import GROUP_ROWS, pack_ternary_device
from smmb_tpu_torch.kernels import fused_mlp as fk
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.models.attention import (
    LORA_SLICE,
    TernaryAttentionConfig,
    _qkv_prenorm_fusable,
    attention_decode_core,
    attention_decode_step,
    attention_forward,
    attention_prefill,
    init_attention,
    init_kv_cache,
    pack_attention,
)
from smmb_tpu_torch.models.train import absmean_scale, ternarize_ste
from smmb_tpu_torch.ops.dense import prelu
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils import rng


@dataclasses.dataclass(frozen=True)
class TernaryBlockConfig:
    d_model: int
    n_heads: int
    d_ff: int
    alpha: float = 0.2  # PReLU slope in the MLP
    causal: bool = True
    non_zero: int = 2
    eps: float = 1e-6
    n_kv_heads: int | None = None  # grouped-query attention; None = MHA
    rope: bool = False
    rope_theta: float = 10000.0
    window: int | None = None

    @property
    def attn(self) -> TernaryAttentionConfig:
        return TernaryAttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads, causal=self.causal,
            non_zero=self.non_zero, n_kv_heads=self.n_kv_heads, rope=self.rope,
            rope_theta=self.rope_theta, window=self.window,
        )


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    ms = (x.to(torch.float32) ** 2).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps)).to(x.dtype) * g


def init_block(gen: torch.Generator, cfg: TernaryBlockConfig) -> dict:
    """Masters of one block on ``gen``'s device."""
    attn = init_attention(gen, cfg.attn)
    dev = gen.device
    return {
        "attn": attn,
        "w_up": rng.rand_ternary(gen, (cfg.d_model, cfg.d_ff), non_zero=cfg.non_zero),
        "b_up": rng.rand_dense(gen, (cfg.d_ff,)),
        "w_down": rng.rand_ternary(gen, (cfg.d_ff, cfg.d_model), non_zero=cfg.non_zero),
        "b_down": rng.rand_dense(gen, (cfg.d_model,)),
        "norm1": torch.ones((cfg.d_model,), device=dev),
        "norm2": torch.ones((cfg.d_model,), device=dev),
    }


def pack_block(params: dict, quantize: bool = False) -> dict:
    """Masters → packed serving block (see ``pack_mlp`` for ``quantize``)."""

    def one(name):
        w = params[name]
        if quantize:
            return pack_ternary_device(ternarize_ste(w)), absmean_scale(w).to(torch.float32)
        return pack_ternary_device(w), torch.ones((), dtype=torch.float32, device=w.device)

    w_up, s_up = one("w_up")
    w_down, s_down = one("w_down")
    return {
        "attn": pack_attention(params["attn"], quantize=quantize),
        "w_up": w_up, "s_up": s_up, "b_up": params["b_up"],
        "w_down": w_down, "s_down": s_down, "b_down": params["b_down"],
        "norm1": params["norm1"], "norm2": params["norm2"],
    }


def init_block_cache(cfg: TernaryBlockConfig, batch: int, max_len: int,
                     dtype=torch.float32, quantized: bool = False,
                     ragged: bool = False, device=None) -> dict:
    """KV cache for one block's attention (see ``attention.init_kv_cache``)."""
    return init_kv_cache(cfg.attn, batch, max_len, dtype, quantized, ragged, device)


def _fused_block_h(hdim: int, cap: int = 2048) -> int:
    """Largest hidden-slab width ≤ ``cap`` that divides ``hdim`` and is a
    multiple of GROUP_ROWS; 0 when none exists (JAX's rule, kept so the
    slab a gate checks is the slab the call passes)."""
    best = 0
    for bh in range(GROUP_ROWS, min(cap, hdim) + 1, GROUP_ROWS):
        if hdim % bh == 0:
            best = bh
    return best


def _mlp_fusable(packed, h2d, compute_dtype, use_kernel) -> bool:
    """Route the small-M MLP half through one ``fused_mlp`` call (B6)?

    Semantic (as JAX): the kernel is on, no LoRA on either MLP weight,
    M ≤ 32 rows, a float compute dtype, K aligned to the 512-row group, a
    valid hidden slab, and the ``w_down`` shape chain. Hopper limit: the
    (8, K) f32 rows a block stages fit its shared memory
    (``fused_mlp.fits_shared``: K ≤ 6656), in place of JAX's Mosaic cap."""
    k = h2d.shape[-1]
    hdim = packed["w_up"].shape[1]
    return bool(
        use_kernel
        and packed.get("w_up_lora") is None
        and packed.get("w_down_lora") is None
        and h2d.shape[0] <= 32
        and compute_dtype in fk.FLOAT_DTYPES
        and k % GROUP_ROWS == 0
        and fk.fits_shared(k)
        and _fused_block_h(hdim, 1024) > 0
        and packed["w_down"].shape == (hdim, k)
    )


def _tail_fusable(packed, m, compute_dtype, use_kernel) -> bool:
    """Route the block tail (wo + residual + norm2 + MLP) through one
    ``fused_block_tail`` call (B5)?

    Semantic (as JAX): the kernel is on, M ≤ 32 rows, a float compute
    dtype, no LoRA on any fused weight, A, D and H aligned to the 512-row
    group (H through a valid slab), and the ``w_down`` shape chain. Hopper
    limit: the (8, A) and (8, D) f32 rows its launches stage fit a block's
    shared memory (``fused_mlp.fits_shared``), in place of JAX's Mosaic
    caps on A and D."""
    ap = packed["attn"]
    a, dm = ap["wo"].shape
    hdim = packed["w_up"].shape[1]
    return bool(
        use_kernel
        and m <= 32
        and compute_dtype in fk.FLOAT_DTYPES
        and ap.get("wo_lora") is None
        and packed.get("w_up_lora") is None
        and packed.get("w_down_lora") is None
        and a % GROUP_ROWS == 0
        and fk.fits_shared(a)
        and dm % GROUP_ROWS == 0
        and fk.fits_shared(dm)
        and _fused_block_h(hdim) > 0
        and packed["w_down"].shape == (hdim, dm)
    )


def _fused_tail(packed, out, x, cfg, compute_dtype):
    """``fused_block_tail`` on the pre-``wo`` mix ``out`` (B, T, A) with the
    residual stream ``x`` (B, T, D)."""
    ap = packed["attn"]
    y = fk.fused_block_tail(
        out.reshape(-1, out.shape[-1]), x.reshape(-1, x.shape[-1]),
        ap["wo"], ap["wo_scale"], ap["bo"], packed["norm2"],
        packed["w_up"], packed["s_up"], packed["b_up"],
        packed["w_down"], packed["s_down"], packed["b_down"],
        alpha=cfg.alpha, eps=cfg.eps, compute_dtype=compute_dtype,
        block_h=_fused_block_h(packed["w_up"].shape[1]),
    )
    return y.reshape(x.shape)


def _mlp_half(packed, x, cfg, spmm, compute_dtype=None, use_kernel=False):
    if packed.get("w_up_lora") is not None or packed.get("w_down_lora") is not None:
        raise NotImplementedError(LORA_SLICE)
    h = rmsnorm(x, packed["norm2"], cfg.eps)
    h2d = h.reshape(-1, h.shape[-1])
    if compute_dtype is not None and _mlp_fusable(packed, h2d, compute_dtype, use_kernel):
        down = fk.fused_mlp(
            h2d, packed["w_up"], packed["s_up"], packed["b_up"],
            packed["w_down"], packed["s_down"], packed["b_down"],
            alpha=cfg.alpha, compute_dtype=compute_dtype,
            block_h=_fused_block_h(packed["w_up"].shape[1], 1024),
        ).reshape(x.shape)
        return x + down
    up = spmm(h, packed["w_up"], packed["s_up"], packed["b_up"], cfg.alpha)
    return x + spmm(up, packed["w_down"], packed["s_down"], packed["b_down"])


def _make_spmm(compute_dtype, use_kernel):
    def spmm(inp, w, s, b, alpha=None):
        inp = inp * s
        if use_kernel:
            return packed_spmm(inp, w, b, alpha, compute_dtype=compute_dtype)
        return packed_spmm_ref(inp, w, b, alpha, dtype=compute_dtype)

    return spmm


def block_forward(packed: dict, x: torch.Tensor, cfg: TernaryBlockConfig, *,
                  compute_dtype=torch.float32, use_kernel: bool = True,
                  use_flash: bool = False) -> torch.Tensor:
    """Pre-norm block: x + attn(norm(x)), then x + mlp(norm(x))."""
    h = rmsnorm(x, packed["norm1"], cfg.eps)
    x = x + attention_forward(packed["attn"], h, cfg.attn,
                              compute_dtype=compute_dtype, use_kernel=use_kernel,
                              use_flash=use_flash)
    return _mlp_half(packed, x, cfg, _make_spmm(compute_dtype, use_kernel),
                     compute_dtype, use_kernel)


def block_prefill(packed: dict, x: torch.Tensor, cache: dict,
                  cfg: TernaryBlockConfig, *, compute_dtype=torch.float32,
                  use_kernel: bool = True, use_flash: bool = False):
    """Prompt pass: full block forward + KV-cache fill. Returns (y, cache)."""
    h = rmsnorm(x, packed["norm1"], cfg.eps)
    att, cache = attention_prefill(
        packed["attn"], h, cache, cfg.attn, compute_dtype=compute_dtype,
        use_kernel=use_kernel, use_flash=use_flash)
    x = x + att
    return _mlp_half(packed, x, cfg, _make_spmm(compute_dtype, use_kernel),
                     compute_dtype, use_kernel), cache


def block_decode_step(packed: dict, x_t: torch.Tensor, cache: dict,
                      cfg: TernaryBlockConfig, *, compute_dtype=torch.float32,
                      use_kernel: bool = True, use_flash: bool = False):
    """One decode step through the block: x_t (B, 1, d_model). With the
    gates on, the block is B3 (norm1 + QKV), the attention math and B5."""
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel)
    b, t, _ = x_t.shape
    if _tail_fusable(packed, b * t, compute_dtype, use_kernel):
        if _qkv_prenorm_fusable(packed["attn"], cfg.attn, compute_dtype, use_kernel):
            out, cache = attention_decode_core(
                packed["attn"], x_t, cache, cfg.attn, use_flash=use_flash,
                prenorm=(packed["norm1"], cfg.eps), **kw)
        else:
            h = rmsnorm(x_t, packed["norm1"], cfg.eps)
            out, cache = attention_decode_core(
                packed["attn"], h, cache, cfg.attn, use_flash=use_flash, **kw)
        return _fused_tail(packed, out, x_t, cfg, compute_dtype), cache
    h = rmsnorm(x_t, packed["norm1"], cfg.eps)
    att, cache = attention_decode_step(packed["attn"], h, cache, cfg.attn,
                                       use_flash=use_flash, **kw)
    x_t = x_t + att
    return _mlp_half(packed, x_t, cfg, _make_spmm(compute_dtype, use_kernel),
                     compute_dtype, use_kernel), cache
