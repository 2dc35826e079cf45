"""Tensor-parallel attention + expert-parallel FFN for MoE blocks
(counterpart of smmb_tpu/parallel/tp_moe.py).

The multi-rank MoE serving layout: the same ``model`` axis carries both
partitionings of one block —

* attention: Megatron head sharding (column Q/K/V, row out-projection, one
  all_reduce), parallel/tp_transformer.py's attention half as it is, so
  ``use_flash`` reaches B9 in the prefill and B4 (B8 over an int8 cache) in
  the decode steps, and the decode step's Q/K/V are one B1 call on the
  rank's fused plane;
* FFN: whole experts sharded on their stacked axis (parallel/ep_moe.py):
  activations are model-replicated under TP, so every rank routes all of
  its tokens alike against the replicated router, computes the slabs of its
  own experts and one all_reduce assembles the combine.

Two all_reduces a block, as the dense TP block. Serving routes drop-free
(models/moe.moe_forward's ``no_drop`` rule, capacity n rounded up to 8), so
the dispatch is the single-rank block's and the TP-EP forward equals
``moe_block_forward`` up to the attention all_reduce's sum order.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.models.moe import _round8
from smmb_tpu_torch.models.moe_block import TernaryMoEBlockConfig
from smmb_tpu_torch.models.transformer import rmsnorm
from smmb_tpu_torch.parallel.ep_moe import ep_ffn_body, shard_moe_ep
from smmb_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from smmb_tpu_torch.parallel.tp_transformer import (
    _attn_decode_half_tp,
    _attn_half_tp,
    init_block_cache_tp,
    shard_attn_megatron,
)


def _reject_lora_tpep(packed: dict) -> None:
    if any(k.endswith("_lora") for k in list(packed) + list(packed.get("attn", ()))):
        raise ValueError("LoRA adapters are not supported on the TP-EP path yet — "
                         "serve adapted models through the single-device API")


def _check_divisible(cfg: TernaryMoEBlockConfig, ms: int) -> None:
    if cfg.n_heads % ms or cfg.attn.kv_heads % ms:
        raise ValueError(f"n_heads={cfg.n_heads}/kv={cfg.attn.kv_heads} % model={ms} != 0")
    if cfg.n_experts % ms:
        raise ValueError(f"n_experts={cfg.n_experts} % model={ms} != 0")


def _checked(packed: dict, cfg: TernaryMoEBlockConfig, mesh: Mesh) -> None:
    _check_divisible(cfg, mesh.axis_size(MODEL_AXIS))
    _reject_lora_tpep(packed)


def shard_moe_block_tp(packed: dict, mesh: Mesh) -> dict:
    """The rank's shard of one packed MoE block (models/moe_block.
    pack_moe_block): attention Megatron-sharded, experts expert-parallel,
    norms whole."""
    _reject_lora_tpep(packed)
    dev = mesh.device
    return {
        "attn": shard_attn_megatron(packed["attn"], mesh),
        "moe": shard_moe_ep(packed["moe"], mesh),
        "norm1": packed["norm1"].to(dev),
        "norm2": packed["norm2"].to(dev),
    }


def _moe_ffn_half_tp(d, x_mid, cfg, mesh, compute_dtype, use_kernel):
    """norm2 and the expert-parallel MoE on the model-replicated tokens,
    drop-free, one all_reduce: ``x + moe``."""
    b, t, dm = x_mid.shape
    h2 = rmsnorm(x_mid, d["norm2"], cfg.eps).reshape(b * t, dm)
    y = ep_ffn_body(h2, d["moe"], cfg.moe, mesh, _round8(b * t), compute_dtype, use_kernel)
    return x_mid + y.reshape(b, t, dm)


def moe_block_forward_tp(packed: dict, x: torch.Tensor, cfg: TernaryMoEBlockConfig, *,
                         mesh: Mesh, compute_dtype=torch.float32, use_kernel: bool = True,
                         use_flash: bool = False) -> torch.Tensor:
    """TP-EP MoE block forward: x (B_local, T, d_model), the rank's batch
    rows, replicated over ``model``; returns y likewise."""
    _checked(packed, cfg, mesh)
    x_mid, _ = _attn_half_tp(packed, x, cfg, mesh, compute_dtype, use_kernel, use_flash)
    return _moe_ffn_half_tp(packed, x_mid, cfg, mesh, compute_dtype, use_kernel)


def init_moe_block_cache_tp(cfg: TernaryMoEBlockConfig, batch: int, max_len: int,
                            mesh: Mesh, dtype=torch.float32, quantized: bool = False) -> dict:
    """The rank's KV cache for one TP-EP MoE block: the dense TP block's
    layout (everything cache-shaped lives in the attention half)."""
    return init_block_cache_tp(cfg, batch, max_len, mesh, dtype, quantized)


def moe_block_decode_step_tp(packed: dict, x_t: torch.Tensor, cache: dict,
                             cfg: TernaryMoEBlockConfig, *, mesh: Mesh,
                             compute_dtype=torch.float32, use_kernel: bool = True,
                             use_flash: bool = False):
    """One TP-EP decode step: x_t (B_local, 1, d_model). Attention reads and
    writes the rank's own heads only, the token routes drop-free through
    the rank's experts; two all_reduces, as the dense TP decode step.
    Returns (y_t, cache)."""
    _checked(packed, cfg, mesh)
    x, cache = _attn_decode_half_tp(packed, x_t, cache, cfg, mesh, compute_dtype, use_kernel,
                                    use_flash)
    return _moe_ffn_half_tp(packed, x, cfg, mesh, compute_dtype, use_kernel), cache


def moe_block_prefill_tp(packed: dict, x: torch.Tensor, cache: dict,
                         cfg: TernaryMoEBlockConfig, *, mesh: Mesh,
                         compute_dtype=torch.float32, use_kernel: bool = True,
                         use_flash: bool = False):
    """TP-EP prompt pass: the MoE block forward plus the fill of the rank's
    cache heads (its Q/K/V projections serve both). Returns (y, cache)."""
    _checked(packed, cfg, mesh)
    x_mid, cache = _attn_half_tp(packed, x, cfg, mesh, compute_dtype, use_kernel, use_flash,
                                 cache=cache)
    return _moe_ffn_half_tp(packed, x_mid, cfg, mesh, compute_dtype, use_kernel), cache
