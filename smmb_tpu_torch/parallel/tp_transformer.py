"""Tensor-parallel ternary transformer block and LM over the process mesh
(counterpart of smmb_tpu/parallel/tp_transformer.py).

Megatron-style sharding of models/transformer.py's pre-norm block, built
on the packed-plane partitioners of parallel/sharded.py:

* Q/K/V projections **column-parallel**: each model rank owns
  ``n_heads / model`` whole heads (and ``kv_heads / model`` KV heads), so
  the attention math runs rank-locally with no collective;
* out-projection **row-parallel**: its contraction axis is the head feature
  axis the rank already owns; the partials meet in one ``all_reduce``;
* MLP up **column-parallel** (the PReLU fused, elementwise on owned
  columns), down **row-parallel**, closing with the second ``all_reduce``.

Two model-axis ``all_reduce``s a block, the textbook count. The attention
runs through the port's models/attention.py functions on the rank's heads,
under a per-rank ``TernaryAttentionConfig`` of those heads, so ``use_flash``
reaches B9 in the prefill and B4 (B8 over an int8 cache) in the decode
steps exactly as on one rank, under the same gates; the decode step's Q, K
and V are one B1 call on the rank's fused ``[Wq|Wk|Wv]`` columns. Every
projection is B1 on the rank's shard. The KV caches hold the rank's heads
only, so decode needs no cache collective. JAX's TP ``generate_tp`` uses
the flash kernel in its prefill only; the port's uses B4 in its decode
steps too, as the port's single-rank ``generate`` does.

Tensors in and out are the rank's blocks (batch rows over "data",
replicated over "model"); a ``batch`` size argument is the global batch, as
in JAX. The LM head is vocab-sharded and its logits gathered over the model
axis, so every rank returns whole logits for its rows.

MoE blocks (JAX's ``tp_moe`` route) and LoRA entries under TP belong to
the next slice of the port and raise ``NotImplementedError`` here.

Sharding constraints (enforced by the partitioners and checks here):
``n_heads`` and ``kv_heads`` divisible by model; ``d_model`` and the KV
width multiples of 128·model for the QKV column shards; ``d_model`` and
``d_ff`` multiples of 512·model for the two row-sharded contractions.
"""

from __future__ import annotations

import dataclasses

import torch

from smmb_tpu_torch.formats.packed import concat_packed_cols
from smmb_tpu_torch.models.attention import (
    _attention_math,
    _cache_write,
    _positions,
    _proj,
    _split_heads,
    apply_rope,
    attention_decode_core,
    init_kv_cache,
)
from smmb_tpu_torch.models.transformer import TernaryBlockConfig, rmsnorm
from smmb_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    LORA_SLICE,
    MODEL_AXIS,
    MOE_SLICE,
    Mesh,
    all_gather,
    all_reduce,
)
from smmb_tpu_torch.parallel.sharded import (
    _bias_cols,
    _local_spmm,
    _partial,
    shard_packed_columns,
    shard_packed_rows,
)


def _model_size(mesh: Mesh) -> int:
    return mesh.axis_size(MODEL_AXIS)


def _reject(packed: dict) -> None:
    """MoE blocks and LoRA adapters are the next slice's."""
    if "moe" in packed:
        raise NotImplementedError(MOE_SLICE)
    if any(k.endswith("_lora") for d in (packed, packed.get("attn", {})) for k in d):
        raise NotImplementedError(LORA_SLICE)


def _check_heads(attn_cfg, ms: int) -> None:
    if attn_cfg.n_heads % ms:
        raise ValueError(f"n_heads={attn_cfg.n_heads} % model={ms} != 0")
    if attn_cfg.kv_heads % ms:
        raise ValueError(f"n_kv_heads={attn_cfg.kv_heads} % model={ms} != 0")


def _local_cfg(attn_cfg, ms: int):
    """The attention config of the rank's heads (head_dim unchanged)."""
    _check_heads(attn_cfg, ms)
    return dataclasses.replace(attn_cfg, d_model=attn_cfg.d_model // ms,
                               n_heads=attn_cfg.n_heads // ms,
                               n_kv_heads=attn_cfg.kv_heads // ms)


def shard_attn_megatron(a: dict, mesh: Mesh) -> dict:
    """The rank's Megatron shard of one packed attention dict: column Q/K/V
    (biases sliced with their columns, plus the rank's fused ``[Wq|Wk|Wv]``
    plane with its per-column scale and bias), row out-projection (bias
    whole)."""
    dev = mesh.device
    attn = {}
    for name in ("wq", "wk", "wv"):
        bname = name.replace("w", "b")
        attn[name] = shard_packed_columns(a[name], mesh)
        attn[name + "_scale"] = a[name + "_scale"].to(dev)
        attn[bname] = _bias_cols(a[bname], mesh, attn[name].cols)
    attn["wqkv"] = concat_packed_cols([attn["wq"], attn["wk"], attn["wv"]])
    attn["qkv_scale"] = torch.cat([attn[n + "_scale"].expand(attn[n].cols)
                                   for n in ("wq", "wk", "wv")])
    attn["bqkv"] = torch.cat([attn["bq"], attn["bk"], attn["bv"]])
    attn["wo"] = shard_packed_rows(a["wo"], mesh)
    attn["wo_scale"] = a["wo_scale"].to(dev)
    attn["bo"] = a["bo"].to(dev)
    return attn


def shard_block_tp(packed: dict, mesh: Mesh) -> dict:
    """The rank's shard of one packed block (models/transformer.pack_block):
    QKV and MLP-up column-sharded, out-projection and MLP-down row-sharded;
    column biases sliced, row biases, scales and norm gains whole."""
    _reject(packed)
    dev = mesh.device
    w_up = shard_packed_columns(packed["w_up"], mesh)
    return {
        "attn": shard_attn_megatron(packed["attn"], mesh),
        "w_up": w_up,
        "s_up": packed["s_up"].to(dev),
        "b_up": _bias_cols(packed["b_up"], mesh, w_up.cols),
        "w_down": shard_packed_rows(packed["w_down"], mesh),
        "s_down": packed["s_down"].to(dev),
        "b_down": packed["b_down"].to(dev),
        "norm1": packed["norm1"].to(dev),
        "norm2": packed["norm2"].to(dev),
    }


def _row_out(w, scale, inp, bias, mesh, compute_dtype, use_kernel):
    """A row-parallel projection: the rank's partial (the scale folded into
    its input), one model-axis all_reduce, then the whole bias."""
    part = _partial(inp * scale, w, compute_dtype, use_kernel)
    return all_reduce(part, mesh, MODEL_AXIS) + bias


def _attn_half_tp(d, x, cfg, mesh, compute_dtype, use_kernel, use_flash, cache=None,
                  valid=None):
    """norm1, the rank's Q/K/V (B1 each), optionally the cache fill (keys
    cached roped), the rank-local attention math (B9 under ``use_flash``),
    then the row out-projection: ``x + attention`` and the cache."""
    lcfg = _local_cfg(cfg.attn, _model_size(mesh))
    a = d["attn"]
    h = rmsnorm(x, d["norm1"], cfg.eps)
    q, k, v = (_proj(a, n, h, lcfg, compute_dtype, use_kernel) for n in ("wq", "wk", "wv"))
    if cache is not None:
        pos, t = cache["pos"], x.shape[1]
        kc = _split_heads(k, lcfg, lcfg.kv_heads)
        if lcfg.rope:
            kc = apply_rope(kc, _positions(pos, t, x.device), lcfg.rope_theta)
        cache = _cache_write(cache, kc, _split_heads(v, lcfg, lcfg.kv_heads), pos, valid)
    att = _attention_math(q, k, v, lcfg, use_flash=use_flash and valid is None, valid=valid)
    out = _row_out(a["wo"], a["wo_scale"], att, a["bo"], mesh, compute_dtype, use_kernel)
    return x + out.to(x.dtype), cache


def _mlp_half_tp(d, x, cfg, mesh, compute_dtype, use_kernel):
    """norm2, the column MLP-up with its PReLU fused, the row MLP-down and
    its all_reduce: ``x + mlp``."""
    h = rmsnorm(x, d["norm2"], cfg.eps)
    up = _local_spmm(h * d["s_up"], d["w_up"], d["b_up"], cfg.alpha, compute_dtype,
                     use_kernel)
    down = _row_out(d["w_down"], d["s_down"], up, d["b_down"], mesh, compute_dtype,
                    use_kernel)
    return x + down.to(x.dtype)


def block_forward_tp(packed: dict, x: torch.Tensor, cfg: TernaryBlockConfig, *,
                     mesh: Mesh, compute_dtype=torch.float32, use_kernel: bool = True,
                     use_flash: bool = False) -> torch.Tensor:
    """Tensor-parallel block forward: x (B_local, T, d_model), the rank's
    batch rows, replicated over ``model``; returns y likewise."""
    x, _ = _attn_half_tp(packed, x, cfg, mesh, compute_dtype, use_kernel, use_flash)
    return _mlp_half_tp(packed, x, cfg, mesh, compute_dtype, use_kernel)


def _local_batch(batch: int, mesh: Mesh) -> int:
    dsz = mesh.axis_size(DATA_AXIS)
    if batch % dsz:
        raise ValueError(f"batch {batch} not divisible by data axis {dsz}")
    return batch // dsz


def init_block_cache_tp(cfg: TernaryBlockConfig, batch: int, max_len: int, mesh: Mesh,
                        dtype=torch.float32, quantized: bool = False,
                        ragged: bool = False) -> dict:
    """The rank's KV cache for one TP block: its batch // data rows and its
    kv_heads / model heads, flat (B, S, KVH_local·hd) ``k``/``v``, or the
    merged int8 layout of those heads (``quantized``); see
    ``attention.init_kv_cache``. ``batch`` is the global batch."""
    lcfg = _local_cfg(cfg.attn, _model_size(mesh))
    return init_kv_cache(lcfg, _local_batch(batch, mesh), max_len, dtype, quantized,
                         ragged, device=mesh.device)


def block_decode_step_tp(packed: dict, x_t: torch.Tensor, cache: dict,
                         cfg: TernaryBlockConfig, *, mesh: Mesh,
                         compute_dtype=torch.float32, use_kernel: bool = True,
                         use_flash: bool = False):
    """One TP decode step: x_t (B_local, 1, d_model). The rank's Q/K/V are
    one B1 call on its fused plane, the cache read is B4 (B8 over an int8
    cache) under ``use_flash`` and the decode gate, and the block's two
    all_reduces are its only collectives. Returns (y_t, cache)."""
    lcfg = _local_cfg(cfg.attn, _model_size(mesh))
    a = packed["attn"]
    h = rmsnorm(x_t, packed["norm1"], cfg.eps)
    out, cache = attention_decode_core(a, h, cache, lcfg, compute_dtype=compute_dtype,
                                       use_kernel=use_kernel, use_flash=use_flash)
    att = _row_out(a["wo"], a["wo_scale"], out, a["bo"], mesh, compute_dtype, use_kernel)
    x = x_t + att.to(x_t.dtype)
    return _mlp_half_tp(packed, x, cfg, mesh, compute_dtype, use_kernel), cache


def block_prefill_tp(packed: dict, x: torch.Tensor, cache: dict, cfg: TernaryBlockConfig,
                     *, mesh: Mesh, compute_dtype=torch.float32, use_kernel: bool = True,
                     use_flash: bool = False, valid=None):
    """TP prompt pass: the block forward plus the fill of the rank's cache
    heads. ``valid`` (B_local, T) marks the real tokens of a left-padded
    ragged batch (a ragged cache; the plain attention math reads it)."""
    x, cache = _attn_half_tp(packed, x, cfg, mesh, compute_dtype, use_kernel, use_flash,
                             cache=cache, valid=valid)
    return _mlp_half_tp(packed, x, cfg, mesh, compute_dtype, use_kernel), cache


# ------------------------------------------------------------ LM level
def shard_lm_tp(packed: dict, mesh: Mesh) -> dict:
    """The rank's shard of a packed LM (models/lm.pack_lm): every block TP-
    sharded, the head column-sharded (vocab split), embeddings, positions
    and the final norm whole."""
    dev = mesh.device
    return {
        "embed": packed["embed"].to(dev),
        "pos": packed["pos"].to(dev),
        "blocks": [shard_block_tp(b, mesh) for b in packed["blocks"]],
        "norm_f": packed["norm_f"].to(dev),
        "head": shard_packed_columns(packed["head"], mesh),
        "head_scale": packed["head_scale"].to(dev),
    }


def _head_logits_tp(packed, h, cfg, mesh, compute_dtype, use_kernel):
    """Vocab-sharded LM head: the rank's column SpMM (in f32 on the plain
    path, as the single-rank head), then the vocab panels gathered over the
    model axis so every rank holds whole logits."""
    b, t, d = h.shape
    h2 = h.reshape(b * t, d)
    y = _local_spmm(h2, packed["head"], None, None,
                    compute_dtype if use_kernel else torch.float32, use_kernel)
    y = y * packed["head_scale"]
    return all_gather(y, mesh, MODEL_AXIS, dim=-1).reshape(b, t, cfg.vocab)


def _dense_only(cfg) -> None:
    if cfg.n_experts is not None:
        raise NotImplementedError(MOE_SLICE)


def lm_forward_tp(packed: dict, tokens: torch.Tensor, cfg, *, mesh: Mesh,
                  compute_dtype=torch.float32, use_kernel: bool = True,
                  use_flash: bool = False) -> torch.Tensor:
    """Tensor-parallel LM forward: the rank's (B_local, T) tokens →
    (B_local, T, vocab) logits, vocab gathered."""
    _dense_only(cfg)
    t = tokens.shape[1]
    x = packed["embed"][tokens] + packed["pos"][None, :t]
    for blk in packed["blocks"]:
        x = block_forward_tp(blk, x, cfg.block, mesh=mesh, compute_dtype=compute_dtype,
                             use_kernel=use_kernel, use_flash=use_flash)
    h = rmsnorm(x, packed["norm_f"], cfg.eps)
    return _head_logits_tp(packed, h, cfg, mesh, compute_dtype, use_kernel)


def lm_init_cache_tp(cfg, batch: int, mesh: Mesh, dtype=torch.float32,
                     quantized: bool = False, ragged: bool = False) -> list:
    """The rank's head-sharded KV caches for every block of a TP LM
    (``batch`` global)."""
    _dense_only(cfg)
    return [init_block_cache_tp(cfg.block, batch, cfg.max_len, mesh, dtype=dtype,
                                quantized=quantized, ragged=ragged)
            for _ in range(cfg.n_layers)]


def lm_prefill_tp(packed: dict, tokens: torch.Tensor, cache: list, cfg, *, mesh: Mesh,
                  compute_dtype=torch.float32, use_kernel: bool = True,
                  use_flash: bool = False, prompt_mask=None):
    """TP prompt pass: (last-position logits (B_local, vocab), filled
    caches). ``prompt_mask`` (B_local, T) bool marks the real tokens of a
    left-padded ragged batch (ragged caches): each row's learned position
    is its logical one, ``clip(cumsum(mask) - 1, 0)``."""
    _dense_only(cfg)
    t = tokens.shape[1]
    if prompt_mask is None:
        x = packed["embed"][tokens] + packed["pos"][None, :t]
    else:
        prompt_mask = prompt_mask.to(torch.bool)
        pos_ids = (torch.cumsum(prompt_mask.to(torch.int64), dim=1) - 1).clamp_min(0)
        x = packed["embed"][tokens] + packed["pos"][pos_ids]
    new_cache = []
    for blk, c in zip(packed["blocks"], cache):
        x, c = block_prefill_tp(blk, x, c, cfg.block, mesh=mesh, compute_dtype=compute_dtype,
                                use_kernel=use_kernel, use_flash=use_flash, valid=prompt_mask)
        new_cache.append(c)
    h = rmsnorm(x, packed["norm_f"], cfg.eps)
    return _head_logits_tp(packed, h, cfg, mesh, compute_dtype, use_kernel)[:, -1], new_cache


def lm_decode_step_tp(packed: dict, token_t: torch.Tensor, cache: list, cfg, *,
                      mesh: Mesh, compute_dtype=torch.float32, use_kernel: bool = True,
                      pos_ids=None, use_flash: bool = False):
    """One TP decode step: (B_local,) tokens → ((B_local, vocab) logits,
    caches). ``pos_ids`` (B_local,) gives each row its own learned-position
    index (ragged batches)."""
    _dense_only(cfg)
    if pos_ids is None:
        pe = packed["pos"][cache[0]["pos"]][None, None]
    else:
        pe = packed["pos"][pos_ids][:, None]
    x = packed["embed"][token_t][:, None, :] + pe
    new_cache = []
    for blk, c in zip(packed["blocks"], cache):
        x, c = block_decode_step_tp(blk, x, c, cfg.block, mesh=mesh,
                                    compute_dtype=compute_dtype, use_kernel=use_kernel,
                                    use_flash=use_flash)
        new_cache.append(c)
    h = rmsnorm(x, packed["norm_f"], cfg.eps)
    return _head_logits_tp(packed, h, cfg, mesh, compute_dtype, use_kernel)[:, 0], new_cache


def generate_tp(packed: dict, prompt: torch.Tensor, cfg, steps: int, *, mesh: Mesh,
                compute_dtype=torch.float32, use_kernel: bool = True,
                use_flash: bool = False, kv_quant: bool = False,
                prompt_mask=None) -> torch.Tensor:
    """TP greedy generation: the rank's (B_local, T) prompt → (B_local,
    steps) tokens, the KV caches head-sharded throughout (the port's
    ``generate`` over the mesh). ``use_flash`` runs the prefill's attention
    through B9 and the decode steps' cache reads through B4 (B8 over an
    int8 cache) under the single-rank gates; ``kv_quant`` stores int8
    codes and scales. ``prompt_mask`` (B_local, T) serves a left-padded
    ragged batch, whose caches the plain attention math reads."""
    if prompt.shape[1] + steps > cfg.max_len:
        raise ValueError(f"prompt_len={prompt.shape[1]} + steps={steps} exceeds "
                         f"max_len={cfg.max_len}")
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel)
    cache = lm_init_cache_tp(cfg, prompt.shape[0] * mesh.axis_size(DATA_AXIS), mesh,
                             dtype=compute_dtype, quantized=kv_quant,
                             ragged=prompt_mask is not None)
    logits, cache = lm_prefill_tp(packed, prompt, cache, cfg, mesh=mesh, use_flash=use_flash,
                                  prompt_mask=prompt_mask, **kw)
    tok = torch.argmax(logits, dim=-1)
    row_pos = None if prompt_mask is None else prompt_mask.to(torch.int64).sum(dim=1)
    toks = []
    for _ in range(steps):
        toks.append(tok)
        logits, cache = lm_decode_step_tp(packed, tok, cache, cfg, mesh=mesh, pos_ids=row_pos,
                                          use_flash=use_flash and row_pos is None, **kw)
        tok = torch.argmax(logits, dim=-1)
        if row_pos is not None:
            row_pos = row_pos + 1
    return torch.stack(toks, dim=1)
