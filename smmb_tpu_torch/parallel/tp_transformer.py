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

LoRA adapters (models/lora.py's ``<name>_lora = (A, B, scale)`` entries)
ride the shards with no collective of their own: on a column-parallel base
(wq, wk, wv, w_up) A stays whole and B's columns split with the base's, so
the rank's residual lands on its own output columns; on a row-parallel base
(wo, w_down) A's rows split with the base's and B stays whole, and the
rank's residual joins its partial before the base's all_reduce. MoE blocks
take parallel/tp_moe.py's TP-EP functions, chosen per block by
``_tp_block_fns``, so the LM-level entry points serve MoE LMs as they serve
dense ones.

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
    lora_residual,
)
from smmb_tpu_torch.models.transformer import TernaryBlockConfig, rmsnorm
from smmb_tpu_torch.ops.dense import prelu
from smmb_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather, all_reduce
from smmb_tpu_torch.parallel.sharded import (
    _bias_cols,
    _local_spmm,
    _partial,
    shard_packed_columns,
    shard_packed_rows,
)


def _model_size(mesh: Mesh) -> int:
    return mesh.axis_size(MODEL_AXIS)


def _reject_moe(packed: dict) -> None:
    """MoE blocks are refused from the dense TP path with a pointer."""
    if "moe" in packed:
        raise ValueError(
            "MoE blocks do not use the dense tensor-parallel path — use "
            "parallel/tp_moe.py (Megatron attention + expert-parallel FFN: "
            "forward/prefill/decode), which the LM-level TP entry points "
            "dispatch to automatically via _tp_block_fns")


# LoRA placement by the adapted layer's kind: which axis of (A, B, scale)
# each rank slices. Column-parallel base: B's output columns follow the
# base's; row-parallel base: A's input rows follow the base's.
_LORA_COL = ("wq", "wk", "wv", "w_up")
_LORA_ROW = ("wo", "w_down")


def _lora_spec(name: str) -> tuple:
    base = name[:-len("_lora")]
    if base in _LORA_COL:
        return (None, 1, None)
    if base not in _LORA_ROW:
        raise ValueError(f"unknown LoRA target {name!r}")
    return (0, None, None)


def _shard_lora_entries(src: dict, dst: dict, mesh: Mesh) -> None:
    """Put the rank's slices of ``src``'s ``*_lora`` entries into ``dst``
    (``_lora_spec``), contiguous, on the mesh's device."""
    ms, j = _model_size(mesh), mesh.index(MODEL_AXIS)
    for k, v in src.items():
        if not k.endswith("_lora"):
            continue
        parts = []
        for arr, axis in zip(v, _lora_spec(k)):
            if axis is not None:
                if arr.shape[axis] % ms:
                    raise ValueError(f"{k}: axis {axis} of {tuple(arr.shape)} % model={ms} != 0")
                w = arr.shape[axis] // ms
                arr = arr.narrow(axis, j * w, w)
            parts.append(arr.to(mesh.device).contiguous())
        dst[k] = tuple(parts)


def _check_heads(attn_cfg, ms: int) -> None:
    if attn_cfg.n_heads % ms:
        raise ValueError(f"n_heads={attn_cfg.n_heads} % model={ms} != 0")
    if attn_cfg.kv_heads % ms:
        raise ValueError(f"n_kv_heads={attn_cfg.kv_heads} % model={ms} != 0")


def _local_cfg(attn_cfg, ms: int):
    """The attention config of the rank's heads (head_dim unchanged)."""
    _check_heads(attn_cfg, ms)
    if attn_cfg.q_dim != attn_cfg.d_model:
        raise ValueError(f"head_dim {attn_cfg.head_dim} sets Q's width apart from d_model: "
                         "the tensor-parallel shards take Q as wide as d_model")
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
    _shard_lora_entries(a, attn, mesh)
    return attn


def shard_block_tp(packed: dict, mesh: Mesh) -> dict:
    """The rank's shard of one packed block (models/transformer.pack_block):
    QKV and MLP-up column-sharded, out-projection and MLP-down row-sharded;
    column biases sliced, row biases, scales and norm gains whole; LoRA
    entries sliced with their bases (``_lora_spec``)."""
    _reject_moe(packed)
    dev = mesh.device
    w_up = shard_packed_columns(packed["w_up"], mesh)
    out = {
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
    _shard_lora_entries(packed, out, mesh)
    return out


def _row_out(w, scale, inp, bias, mesh, compute_dtype, use_kernel, lora=None):
    """A row-parallel projection: the rank's partial (the scale folded into
    its input) plus its slice of an adapter's residual on the raw input,
    one model-axis all_reduce, then the whole bias."""
    part = _partial(inp * scale, w, compute_dtype, use_kernel)
    if lora is not None:
        part = part + lora_residual(inp, lora)
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
    out = _row_out(a["wo"], a["wo_scale"], att, a["bo"], mesh, compute_dtype, use_kernel,
                   a.get("wo_lora"))
    return x + out.to(x.dtype), cache


def _attn_decode_half_tp(d, x_t, cache, cfg, mesh, compute_dtype, use_kernel, use_flash):
    """norm1, the rank's decode-step attention (one B1 call on its fused
    Q/K/V plane, or one a projection when an adapter rides Q, K or V; the
    cache read B4 or B8 under ``use_flash`` and the decode gate), then the
    row out-projection: ``x_t + attention`` and the cache."""
    lcfg = _local_cfg(cfg.attn, _model_size(mesh))
    a = d["attn"]
    h = rmsnorm(x_t, d["norm1"], cfg.eps)
    out, cache = attention_decode_core(a, h, cache, lcfg, compute_dtype=compute_dtype,
                                       use_kernel=use_kernel, use_flash=use_flash)
    att = _row_out(a["wo"], a["wo_scale"], out, a["bo"], mesh, compute_dtype, use_kernel,
                   a.get("wo_lora"))
    return x_t + att.to(x_t.dtype), cache


def _mlp_half_tp(d, x, cfg, mesh, compute_dtype, use_kernel):
    """norm2, the column MLP-up with its PReLU fused, the row MLP-down and
    its all_reduce: ``x + mlp``. An adapter on MLP-up adds before the
    activation, so B1 then runs without its PReLU epilogue and the PReLU
    follows the sum (the single-rank ``_mlp_half``'s route)."""
    h = rmsnorm(x, d["norm2"], cfg.eps)
    up_lora = d.get("w_up_lora")
    if up_lora is None:
        up = _local_spmm(h * d["s_up"], d["w_up"], d["b_up"], cfg.alpha, compute_dtype,
                         use_kernel)
    else:
        pre = _local_spmm(h * d["s_up"], d["w_up"], d["b_up"], None, compute_dtype,
                          use_kernel)
        up = prelu(pre + lora_residual(h, up_lora), cfg.alpha)
    down = _row_out(d["w_down"], d["s_down"], up, d["b_down"], mesh, compute_dtype,
                    use_kernel, d.get("w_down_lora"))
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
    x, cache = _attn_decode_half_tp(packed, x_t, cache, cfg, mesh, compute_dtype, use_kernel,
                                    use_flash)
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
def _tp_block_fns(packed_block: dict) -> dict:
    """The TP block functions for a packed block's kind: dense (this module,
    Megatron) or MoE (parallel/tp_moe.py, Megatron attention and
    expert-parallel FFN), so every LM-level TP entry point serves MoE LMs."""
    if "moe" in packed_block:
        from smmb_tpu_torch.parallel import tp_moe as m  # tp_moe imports this module

        return {"shard": m.shard_moe_block_tp, "forward": m.moe_block_forward_tp,
                "prefill": m.moe_block_prefill_tp, "decode": m.moe_block_decode_step_tp}
    return {"shard": shard_block_tp, "forward": block_forward_tp,
            "prefill": block_prefill_tp, "decode": block_decode_step_tp}


def shard_lm_tp(packed: dict, mesh: Mesh) -> dict:
    """The rank's shard of a packed LM (models/lm.pack_lm): every block TP-
    sharded (dense Megatron or TP-EP MoE, by the block's kind), the head
    column-sharded (vocab split), embeddings, positions and the final norm
    whole."""
    dev = mesh.device
    return {
        "embed": packed["embed"].to(dev),
        "pos": packed["pos"].to(dev),
        "blocks": [_tp_block_fns(b)["shard"](b, mesh) for b in packed["blocks"]],
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


def lm_forward_tp(packed: dict, tokens: torch.Tensor, cfg, *, mesh: Mesh,
                  compute_dtype=torch.float32, use_kernel: bool = True,
                  use_flash: bool = False) -> torch.Tensor:
    """Tensor-parallel LM forward: the rank's (B_local, T) tokens →
    (B_local, T, vocab) logits, vocab gathered."""
    t = tokens.shape[1]
    x = packed["embed"][tokens] + packed["pos"][None, :t]
    for blk in packed["blocks"]:
        x = _tp_block_fns(blk)["forward"](blk, x, cfg.block, mesh=mesh,
                                          compute_dtype=compute_dtype, use_kernel=use_kernel,
                                          use_flash=use_flash)
    h = rmsnorm(x, packed["norm_f"], cfg.eps)
    return _head_logits_tp(packed, h, cfg, mesh, compute_dtype, use_kernel)


def lm_init_cache_tp(cfg, batch: int, mesh: Mesh, dtype=torch.float32,
                     quantized: bool = False, ragged: bool = False) -> list:
    """The rank's head-sharded KV caches for every block of a TP LM
    (``batch`` global); MoE blocks' caches are the dense blocks'."""
    return [init_block_cache_tp(cfg.block, batch, cfg.max_len, mesh, dtype=dtype,
                                quantized=quantized, ragged=ragged)
            for _ in range(cfg.n_layers)]


def lm_prefill_tp(packed: dict, tokens: torch.Tensor, cache: list, cfg, *, mesh: Mesh,
                  compute_dtype=torch.float32, use_kernel: bool = True,
                  use_flash: bool = False, prompt_mask=None):
    """TP prompt pass: (last-position logits (B_local, vocab), filled
    caches). ``prompt_mask`` (B_local, T) bool marks the real tokens of a
    left-padded ragged batch (ragged caches): each row's learned position
    is its logical one, ``clip(cumsum(mask) - 1, 0)``; dense blocks only."""
    t = tokens.shape[1]
    if prompt_mask is None:
        x = packed["embed"][tokens] + packed["pos"][None, :t]
    else:
        prompt_mask = prompt_mask.to(torch.bool)
        pos_ids = (torch.cumsum(prompt_mask.to(torch.int64), dim=1) - 1).clamp_min(0)
        x = packed["embed"][tokens] + packed["pos"][pos_ids]
    new_cache = []
    for blk, c in zip(packed["blocks"], cache):
        kw = {} if prompt_mask is None else {"valid": prompt_mask}
        if prompt_mask is not None and "moe" in blk:
            raise ValueError("ragged prompt_mask is supported for dense TP blocks only")
        x, c = _tp_block_fns(blk)["prefill"](blk, x, c, cfg.block, mesh=mesh,
                                             compute_dtype=compute_dtype, use_kernel=use_kernel,
                                             use_flash=use_flash, **kw)
        new_cache.append(c)
    h = rmsnorm(x, packed["norm_f"], cfg.eps)
    return _head_logits_tp(packed, h, cfg, mesh, compute_dtype, use_kernel)[:, -1], new_cache


def lm_decode_step_tp(packed: dict, token_t: torch.Tensor, cache: list, cfg, *,
                      mesh: Mesh, compute_dtype=torch.float32, use_kernel: bool = True,
                      pos_ids=None, use_flash: bool = False):
    """One TP decode step: (B_local,) tokens → ((B_local, vocab) logits,
    caches). ``pos_ids`` (B_local,) gives each row its own learned-position
    index (ragged batches)."""
    if pos_ids is None:
        pe = packed["pos"][cache[0]["pos"]][None, None]
    else:
        pe = packed["pos"][pos_ids][:, None]
    x = packed["embed"][token_t][:, None, :] + pe
    new_cache = []
    for blk, c in zip(packed["blocks"], cache):
        x, c = _tp_block_fns(blk)["decode"](blk, x, c, cfg.block, mesh=mesh,
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
