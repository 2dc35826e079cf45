"""Ternary attention — the serving part (counterpart of
smmb_tpu/models/attention.py).

All four projections (Q, K, V, out) stream 2-bit ``TernaryPacked`` planes
through ``packed_spmm`` (B1); the fused ``[Wq|Wk|Wv]`` plane serves the
decode step in one call, with the pre-attention RMSNorm riding it through
``fused_norm_qkv`` (B3) when the gate allows. The attention math (scores,
masked softmax, weighted sum) is plain PyTorch, as it is plain jnp in JAX.

The KV cache is a dict of flat (B, S, KVH·hd) float ``k``/``v`` tensors and
a Python int ``pos``. Cache writes update the tensors in place (JAX returns
new arrays; here the preallocated buffers are reused every step) and return
a new dict with ``pos`` advanced. The f32 einsums run in full f32 (TF32 off),
which is JAX's ``Precision.HIGHEST``, so the port has no ``precision``
argument.

Left out of this slice, each with a ``NotImplementedError``: flash attention
(``use_flash``, kernels B4 and B9), the int8 cache (``quantized``, B7 and
B8), ragged caches (``ragged``) and LoRA adapters. Chunked extend
(``attention_extend``) belongs to the serving-controls slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from smmb_tpu_torch.formats.packed import concat_packed_cols, pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.models.train import absmean_scale, ternarize_ste
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils import rng

FLASH_SLICE = ("use_flash=True needs the flash-attention kernels B4 (decode) "
               "and B9 (prefill), which the next slice of the port brings")
INT8_CACHE_SLICE = ("the int8 KV cache needs kernels B7 and B8, which the "
                    "int8-cache slice of the port brings")
RAGGED_SLICE = ("ragged batches (prompt_mask, ragged caches) belong to the "
                "serving-controls slice of the port")
LORA_SLICE = "LoRA adapters belong to the training-surface slice of the port"


@dataclasses.dataclass(frozen=True)
class TernaryAttentionConfig:
    d_model: int
    n_heads: int
    causal: bool = True
    non_zero: int = 2  # expected weight density 1/non_zero
    n_kv_heads: int | None = None  # grouped-query attention; None = MHA
    rope: bool = False  # rotary position embeddings on Q/K
    rope_theta: float = 10000.0
    window: int | None = None  # sliding window: t attends (t-window, t]

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


_PROJS = ("wq", "wk", "wv", "wo")


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings, half-split pairing; x (B, T, H, hd), positions (T,).
    The rotation runs in f32 and casts back."""
    hd = x.shape[-1]
    if hd % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {hd}")
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] * inv[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = torch.split(x.to(torch.float32), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _positions(start: int, t: int, device) -> torch.Tensor:
    return torch.arange(start, start + t, device=device)


def _rope_qk(q, k, cfg: TernaryAttentionConfig, positions):
    """Rope flat (B, T, D) / (B, T, kv_dim) projections through the head
    layout and back; no-op when cfg.rope is off."""
    if not cfg.rope:
        return q, k
    b, t, d = q.shape
    hd = cfg.head_dim
    q = apply_rope(q.reshape(b, t, cfg.n_heads, hd), positions,
                   cfg.rope_theta).reshape(b, t, d)
    k = apply_rope(k.reshape(b, t, cfg.kv_heads, hd), positions,
                   cfg.rope_theta).reshape(b, t, cfg.kv_dim)
    return q, k


def init_attention(gen: torch.Generator, cfg: TernaryAttentionConfig) -> dict:
    """Ternary projection masters + biases (the reference's distributions),
    on ``gen``'s device. Under GQA the K/V projections map to ``kv_dim``."""
    if cfg.d_model % cfg.n_heads:
        raise ValueError(f"d_model {cfg.d_model} % n_heads {cfg.n_heads}")
    if cfg.n_heads % cfg.kv_heads:
        raise ValueError(f"n_heads {cfg.n_heads} % n_kv_heads {cfg.kv_heads} != 0")
    params = {}
    for name in _PROJS:
        cols = cfg.kv_dim if name in ("wk", "wv") else cfg.d_model
        params[name] = rng.rand_ternary(gen, (cfg.d_model, cols), non_zero=cfg.non_zero)
        params[name.replace("w", "b")] = rng.rand_dense(gen, (cols,))
    return params


def pack_attention(params: dict, quantize: bool = False) -> dict:
    """Masters → 2-bit packed serving form (biases pass through), plus the
    fused ``[Wq|Wk|Wv]`` plane with its per-column scale and bias."""
    out = {}
    for name in _PROJS:
        w = params[name]
        if quantize:
            out[name] = pack_ternary_device(ternarize_ste(w))
            out[name + "_scale"] = absmean_scale(w).to(torch.float32)
        else:
            out[name] = pack_ternary_device(w)
            out[name + "_scale"] = torch.ones((), dtype=torch.float32, device=w.device)
        bname = name.replace("w", "b")
        out[bname] = params[bname]
    out["wqkv"] = concat_packed_cols([out["wq"], out["wk"], out["wv"]])
    out["qkv_scale"] = torch.cat([
        out[n + "_scale"].expand(out[n].cols) for n in ("wq", "wk", "wv")
    ])
    out["bqkv"] = torch.cat([out["bq"], out["bk"], out["bv"]])
    return out


def _check_lora(packed: dict, names) -> None:
    if any(packed.get(n + "_lora") is not None for n in names):
        raise NotImplementedError(LORA_SLICE)


def _attention_math(q, k, v, cfg: TernaryAttentionConfig, use_flash=False):
    """(B, T, D) projections → multi-head causal attention, prefill-from-
    empty positions 0..T-1. Under GQA the query heads group over the KV
    heads; the KV tensors are never repeated to the query head count."""
    if use_flash:
        raise NotImplementedError(FLASH_SLICE)
    b, t, d = q.shape
    h, hd, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    g = h // kvh
    q, k = _rope_qk(q, k, cfg, _positions(0, t, q.device))
    q = q.reshape(b, t, kvh, g, hd).permute(0, 2, 3, 1, 4)
    k = k.reshape(b, t, kvh, hd).permute(0, 2, 1, 3)
    v = v.reshape(b, t, kvh, hd).permute(0, 2, 1, 3)
    scores = torch.einsum("bkgqd,bktd->bkgqt", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    if cfg.causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        if cfg.window is not None:
            mask = mask & ~torch.ones_like(mask).tril(-cfg.window)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,bktd->bkgqd", probs.to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, d)


def _proj(packed, name, inp, cfg, compute_dtype, use_kernel):
    _check_lora(packed, (name,))
    w, b = packed[name], packed[name.replace("w", "b")]
    s = packed.get(name + "_scale")
    if s is not None:
        inp = inp * s
    if use_kernel:
        return packed_spmm(inp, w, b, compute_dtype=compute_dtype)
    return packed_spmm_ref(inp, w, b, dtype=compute_dtype)


def _proj_qkv(packed, inp, cfg, compute_dtype, use_kernel):
    """Q, K and V of a decode step as one product with the fused plane;
    scales and bias in f32 after it, cast back to the product's dtype."""
    fused = packed.get("wqkv")
    if fused is None:
        return tuple(_proj(packed, n, inp, cfg, compute_dtype, use_kernel)
                     for n in ("wq", "wk", "wv"))
    _check_lora(packed, ("wq", "wk", "wv"))
    if use_kernel:
        y = packed_spmm(inp, fused, compute_dtype=compute_dtype)
    else:
        y = packed_spmm_ref(inp, fused, dtype=compute_dtype)
    y = (y.to(torch.float32) * packed["qkv_scale"] + packed["bqkv"]).to(y.dtype)
    d, kvd = cfg.d_model, cfg.kv_dim
    return y[..., :d], y[..., d:d + kvd], y[..., d + kvd:]


def attention_forward(packed: dict, x: torch.Tensor, cfg: TernaryAttentionConfig,
                      *, compute_dtype=torch.float32, use_kernel: bool = True,
                      use_flash: bool = False) -> torch.Tensor:
    """Serving forward: packed projections around the attention math.
    x: (B, T, d_model)."""

    def proj(name, inp):
        return _proj(packed, name, inp, cfg, compute_dtype, use_kernel)

    att = _attention_math(proj("wq", x), proj("wk", x), proj("wv", x), cfg,
                          use_flash=use_flash)
    return proj("wo", att)


def init_kv_cache(cfg: TernaryAttentionConfig, batch: int, max_len: int,
                  dtype=torch.float32, quantized: bool = False,
                  ragged: bool = False, device=None) -> dict:
    """Preallocated KV cache for incremental decode: flat (B, S, KVH·hd)
    ``k`` and ``v`` in ``dtype`` on ``device`` (None = the CUDA card), and
    ``pos``, the count of tokens written."""
    from smmb_tpu_torch.utils.device import resolve_device

    if quantized:
        raise NotImplementedError(INT8_CACHE_SLICE)
    if ragged:
        raise NotImplementedError(RAGGED_SLICE)
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads * cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": 0,
    }


def _cache_write(cache: dict, k, v, pos: int) -> dict:
    """Write (B, C, KVH, hd) k/v at ``pos`` into the cache tensors in place;
    returns the cache dict with ``pos`` advanced by C."""
    b, c = k.shape[:2]
    max_len = cache["k"].shape[1]
    if pos + c > max_len:
        raise ValueError(f"cache write at {pos} of {c} tokens exceeds max_len={max_len}")
    cache["k"][:, pos:pos + c] = k.reshape(b, c, -1).to(cache["k"].dtype)
    cache["v"][:, pos:pos + c] = v.reshape(b, c, -1).to(cache["v"].dtype)
    return {**cache, "pos": pos + c}


def _cache_kv(cache: dict, kv_heads: int):
    """The flat cache's K/V as (B, S, KVH, hd) views."""
    b, s, kvd = cache["k"].shape
    hd = kvd // kv_heads
    return (cache["k"].view(b, s, kv_heads, hd),
            cache["v"].view(b, s, kv_heads, hd))


def _split_heads(x, cfg: TernaryAttentionConfig, heads: int | None = None):
    b, t, _ = x.shape
    return x.reshape(b, t, heads or cfg.n_heads, cfg.head_dim)


def attention_prefill(packed: dict, x: torch.Tensor, cache: dict,
                      cfg: TernaryAttentionConfig, *, compute_dtype=torch.float32,
                      use_kernel: bool = True, use_flash: bool = False):
    """Whole prompt (B, T, D): full causal attention (as ``attention_forward``)
    plus the cache fill. Returns (y, cache)."""
    if use_flash:
        raise NotImplementedError(FLASH_SLICE)
    b, t, _ = x.shape
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel)
    k = _split_heads(_proj(packed, "wk", x, cfg, **kw), cfg, cfg.kv_heads)
    v = _split_heads(_proj(packed, "wv", x, cfg, **kw), cfg, cfg.kv_heads)
    pos = cache["pos"]
    if cfg.rope:
        k = apply_rope(k, _positions(pos, t, x.device), cfg.rope_theta)
    cache = _cache_write(cache, k, v, pos)
    y = attention_forward(packed, x, cfg, **kw)
    return y, cache


def _chunk_attention_math(q, kc, vc, pos: int, head_dim: int, window=None):
    """C-token attention over a static-length cache: q (B, C, H, hd), kc/vc
    (B, max_len, KVH, hd) with the chunk already written at [pos, pos+C).
    Query row i attends cache columns ≤ pos+i (and > pos+i-window); the
    rest of the max_len buffer is masked with -inf, and every row sees its
    own token. Returns (B, C, H·hd) in the cache's dtype (the decode step
    is C=1)."""
    b, c = q.shape[:2]
    max_len, kvh = kc.shape[1], kc.shape[2]
    g = q.shape[2] // kvh
    qg = q.reshape(b, c, kvh, g, q.shape[3])
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg.to(torch.float32),
                          kc.to(torch.float32)) / math.sqrt(head_dim)
    qpos = _positions(pos, c, q.device)[:, None]
    cols = torch.arange(max_len, device=q.device)[None, :]
    live = cols <= qpos
    if window is not None:
        live = live & (cols > qpos - window)
    scores = scores.masked_fill(~live, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(vc.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs.to(torch.float32),
                       vc.to(torch.float32)).to(vc.dtype)
    return out.reshape(b, c, -1)


def _qkv_prenorm_fusable(packed, cfg, compute_dtype, use_kernel) -> bool:
    """Can the pre-attention RMSNorm ride the fused QKV kernel (B3)?

    Semantic: the kernel is on, the fused plane exists, no LoRA on Q/K/V,
    a float compute dtype, D aligned to the 512-row packed group and N to
    the 128-column tile JAX checks. Hopper limit: the (8, D) f32 rows a
    block stages fit its shared memory (``fused_mlp.fits_shared``)."""
    from smmb_tpu_torch.kernels.fused_mlp import FLOAT_DTYPES, fits_shared

    return bool(
        use_kernel
        and packed.get("wqkv") is not None
        and not any(packed.get(n + "_lora") is not None for n in ("wq", "wk", "wv"))
        and compute_dtype in FLOAT_DTYPES
        and cfg.d_model % 512 == 0
        and packed["wqkv"].cols % 128 == 0
        and fits_shared(cfg.d_model)
    )


def _proj_qkv_prenorm(packed, x, cfg, prenorm, compute_dtype):
    """norm1 + fused QKV in one kernel call (B3)."""
    from smmb_tpu_torch.kernels.fused_mlp import fused_norm_qkv

    lead = x.shape[:-1]
    y = fused_norm_qkv(
        x.reshape(-1, x.shape[-1]), prenorm[0], packed["wqkv"],
        packed["qkv_scale"], packed["bqkv"], eps=prenorm[1],
        compute_dtype=compute_dtype,
    ).reshape(*lead, -1)
    d, kvd = cfg.d_model, cfg.kv_dim
    return y[..., :d], y[..., d:d + kvd], y[..., d + kvd:]


def attention_decode_core(packed: dict, x_t: torch.Tensor, cache: dict,
                          cfg: TernaryAttentionConfig, *,
                          compute_dtype=torch.float32, use_kernel: bool = True,
                          use_flash: bool = False, prenorm=None):
    """``attention_decode_step`` without the output projection: returns the
    pre-``wo`` mix (B, 1, H·hd) and the cache. With ``prenorm=(g, eps)``,
    x_t is the raw residual stream and the RMSNorm runs inside B3 (the
    caller has checked ``_qkv_prenorm_fusable``)."""
    if use_flash:
        raise NotImplementedError(FLASH_SLICE)
    b, one, _ = x_t.shape
    if one != 1:
        raise ValueError(f"decode step takes one token, got T={one}")
    pos = cache["pos"]
    if prenorm is not None:
        qf, kf, vf = _proj_qkv_prenorm(packed, x_t, cfg, prenorm, compute_dtype)
    else:
        qf, kf, vf = _proj_qkv(packed, x_t, cfg, compute_dtype, use_kernel)
    q = _split_heads(qf, cfg)
    k = _split_heads(kf, cfg, cfg.kv_heads)
    v = _split_heads(vf, cfg, cfg.kv_heads)
    if cfg.rope:
        at = _positions(pos, 1, x_t.device)
        q = apply_rope(q, at, cfg.rope_theta)
        k = apply_rope(k, at, cfg.rope_theta)
    cache = _cache_write(cache, k, v, pos)
    kc, vc = _cache_kv(cache, cfg.kv_heads)
    out = _chunk_attention_math(q, kc, vc, pos, cfg.head_dim, window=cfg.window)
    return out, cache


def attention_decode_step(packed: dict, x_t: torch.Tensor, cache: dict,
                          cfg: TernaryAttentionConfig, *,
                          compute_dtype=torch.float32, use_kernel: bool = True,
                          use_flash: bool = False):
    """One incremental decode step: x_t (B, 1, D) attends the cache plus
    itself. Returns (y_t, cache)."""
    out, cache = attention_decode_core(
        packed, x_t, cache, cfg, compute_dtype=compute_dtype,
        use_kernel=use_kernel, use_flash=use_flash)
    return _proj(packed, "wo", out, cfg, compute_dtype, use_kernel), cache
