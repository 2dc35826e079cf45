"""Ternary attention — the serving part (counterpart of
smmb_tpu/models/attention.py).

All four projections (Q, K, V, out) stream 2-bit ``TernaryPacked`` planes
through ``packed_spmm`` (B1); the fused ``[Wq|Wk|Wv]`` plane serves the
decode and extend steps in one call, with the pre-attention RMSNorm riding it
through ``fused_norm_qkv`` (B3) when the gate allows, or, over an int8 cache
without rope, through ``fused_norm_qkv_quant`` (B7), which writes the cache's
codes itself. The attention math is plain PyTorch by default, as it is plain
jnp in JAX; ``use_flash=True`` routes the prefill through the flash kernel
B9 (kernels/flash_attention.py) and the decode and extend cache reads
through B4, or B8 over an int8 cache (kernels/flash_decode.py), under JAX's
gates.

The KV cache is a dict of flat (B, S, KVH·hd) float ``k``/``v`` tensors, or
of the merged int8 ``kv`` (B, S, 2·KVH·hd) codes and ``kv_scale``
(B, 2·KVH, S) f32 scales (``quantized=True``), and a Python int ``pos``; a
ragged cache (``ragged=True``) adds a (B, S) bool ``valid`` that marks the
real tokens of a left-padded batch (and the live slots of batched
speculative decoding), which every read of the cache masks. Cache writes
update the tensors in place (JAX returns new arrays; here the preallocated
buffers are reused every step) and return a new dict with ``pos`` advanced.
The f32 einsums run in full f32 (TF32 off), which is JAX's
``Precision.HIGHEST``, so the port has no ``precision`` argument. As in JAX,
the flash gates refuse a ragged cache, which is read by the plain math.

The training side (counterpart of smmb_tpu/models/attention.py:941-1039):
``qat_attention_forward`` runs the four projections as STE-ternarized dense
products on the masters around the plain attention math, or, with
``attn_chunk``, around ``attention_math_chunked``, a loop over KV chunks
whose bodies ``torch.utils.checkpoint`` recomputes in the backward. Neither
routes to the flash kernel B9, which has no backward.

LoRA (models/lora.py): a projection whose packed dict carries
``<name>_lora = (A, B, scale)`` adds ``scale·((x A) B)`` of its raw input,
two full f32 products outside any kernel (JAX's residual); an adapted Q, K
or V takes the per-projection path, off the fused plane and off B3 and B7.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from smmb_tpu_torch.formats.packed import concat_packed_cols, pack_ternary_device
from smmb_tpu_torch.kernels import flash_attention as fa
from smmb_tpu_torch.kernels import flash_decode as fd
from smmb_tpu_torch.kernels import fused_mlp as fk
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.models.train import absmean_scale, qat_linear, ternarize_ste
from smmb_tpu_torch.ops.dense import full_f32_matmul
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.spans import (
    ATTN_DECODE,
    ATTN_EXTEND,
    ATTN_KV_FILL,
    ATTN_PREFILL,
    ATTN_QKV_B1,
    ATTN_QKV_B3,
    ATTN_QKV_B7,
    span,
)

# The flash-decode gate for batch > 1, copied from JAX
# (smmb_tpu/models/attention.py:44-45) so that the port takes JAX's route:
# up to FLASH_DECODE_MAX_BATCH rows, and only when the layer's k+v buffers
# hold at least FLASH_DECODE_MIN_CACHE_BYTES. The crossover these encode was
# measured on a TPU v5e against XLA's fused einsum; it is not an H100 fact,
# and the H100's crossover is still to be measured.
FLASH_DECODE_MAX_BATCH = 8
FLASH_DECODE_MIN_CACHE_BYTES = 32 << 20


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
    # width of a head; None = d_model // n_heads (resolved at construction)
    head_dim: int | None = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        """Width of Q and of ``wo``'s input: n_heads · head_dim (d_model
        unless the head width is set apart from it)."""
        return self.n_heads * self.head_dim

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
    b, t, qd = q.shape
    hd = cfg.head_dim
    q = apply_rope(q.reshape(b, t, cfg.n_heads, hd), positions,
                   cfg.rope_theta).reshape(b, t, qd)
    k = apply_rope(k.reshape(b, t, cfg.kv_heads, hd), positions,
                   cfg.rope_theta).reshape(b, t, cfg.kv_dim)
    return q, k


def init_attention(gen: torch.Generator, cfg: TernaryAttentionConfig) -> dict:
    """Ternary projection masters + biases (the reference's distributions),
    on ``gen``'s device. Under GQA the K/V projections map to ``kv_dim``;
    Q maps to ``q_dim`` and ``wo`` back from it."""
    if cfg.d_model % cfg.n_heads and cfg.head_dim == cfg.d_model // cfg.n_heads:
        raise ValueError(f"d_model {cfg.d_model} % n_heads {cfg.n_heads}: give head_dim to "
                         "set the heads' width apart from d_model")
    if cfg.n_heads % cfg.kv_heads:
        raise ValueError(f"n_heads {cfg.n_heads} % n_kv_heads {cfg.kv_heads} != 0")
    shapes = {"wq": (cfg.d_model, cfg.q_dim), "wk": (cfg.d_model, cfg.kv_dim),
              "wv": (cfg.d_model, cfg.kv_dim), "wo": (cfg.q_dim, cfg.d_model)}
    params = {}
    for name in _PROJS:
        rows, cols = shapes[name]
        params[name] = rng.rand_ternary(gen, (rows, cols), non_zero=cfg.non_zero)
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


def lora_residual(raw: torch.Tensor, lora) -> torch.Tensor:
    """An adapter's residual ``scale·((raw A) B)`` in full f32 (JAX's
    ``jnp.matmul`` of the raw layer input, promoted to f32)."""
    a, b, sc = lora
    return full_f32_matmul(full_f32_matmul(raw, a), b) * sc


def _has_lora(packed: dict, names) -> bool:
    return any(packed.get(n + "_lora") is not None for n in names)


def _attention_math(q, k, v, cfg: TernaryAttentionConfig, use_flash=False,
                    valid=None):
    """(B, T, D) projections → multi-head causal attention, prefill-from-
    empty positions 0..T-1. Under GQA the query heads group over the KV
    heads; the KV tensors are never repeated to the query head count.
    ``use_flash`` runs the math as the flash kernel B9 on head views of the
    projections (no (T, T) score tensor). ``valid`` (B, T) bool marks the
    real tokens of a left-padded ragged batch: pad columns are masked out of
    every row, and a pad row attends only itself (its output is never read);
    the plain math only, as in JAX."""
    if valid is not None and use_flash:
        raise ValueError("use_flash does not support ragged (valid) masks")
    with span(ATTN_PREFILL[(0 if use_flash else 2) + (cfg.window is not None)]):
        b, t, d = q.shape
        h, hd, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
        g = h // kvh
        q, k = _rope_qk(q, k, cfg, _positions(0, t, q.device))
        if use_flash:
            out = fa.flash_attention(
                q.reshape(b, t, h, hd).permute(0, 2, 1, 3),
                k.reshape(b, t, kvh, hd).permute(0, 2, 1, 3),
                v.reshape(b, t, kvh, hd).permute(0, 2, 1, 3),
                causal=cfg.causal, window=cfg.window)
            return out.permute(0, 2, 1, 3).reshape(b, t, d)
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
        if valid is not None:
            eye = torch.eye(t, dtype=torch.bool, device=q.device)
            pad_ok = valid.to(device=q.device, dtype=torch.bool)[:, None, :] | eye[None]
            scores = scores.masked_fill(~pad_ok[:, None, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqt,bktd->bkgqd", probs.to(torch.float32),
                           v.to(torch.float32)).to(v.dtype)
        return out.permute(0, 3, 1, 2, 4).reshape(b, t, d)


def _proj(packed, name, inp, cfg, compute_dtype, use_kernel):
    w, b = packed[name], packed[name.replace("w", "b")]
    s = packed.get(name + "_scale")
    raw = inp
    if s is not None:
        inp = inp * s
    if use_kernel:
        y = packed_spmm(inp, w, b, compute_dtype=compute_dtype)
    else:
        y = packed_spmm_ref(inp, w, b, dtype=compute_dtype)
    lora = packed.get(name + "_lora")
    # the adapter sees the raw layer input, not the scaled one
    return y if lora is None else y + lora_residual(raw, lora)


def _proj_qkv(packed, inp, cfg, compute_dtype, use_kernel):
    """Q, K and V of a decode step as one product with the fused plane;
    scales and bias in f32 after it, cast back to the product's dtype. An
    adapted Q, K or V takes the per-projection path, so the adapters see
    their raw layer input."""
    fused = packed.get("wqkv")
    if fused is None or _has_lora(packed, ("wq", "wk", "wv")):
        return tuple(_proj(packed, n, inp, cfg, compute_dtype, use_kernel)
                     for n in ("wq", "wk", "wv"))
    if use_kernel:
        y = packed_spmm(inp, fused, compute_dtype=compute_dtype)
    else:
        y = packed_spmm_ref(inp, fused, dtype=compute_dtype)
    y = (y.to(torch.float32) * packed["qkv_scale"] + packed["bqkv"]).to(y.dtype)
    d, kvd = cfg.q_dim, cfg.kv_dim
    return y[..., :d], y[..., d:d + kvd], y[..., d + kvd:]


def attention_forward(packed: dict, x: torch.Tensor, cfg: TernaryAttentionConfig,
                      *, compute_dtype=torch.float32, use_kernel: bool = True,
                      use_flash: bool = False, valid=None) -> torch.Tensor:
    """Serving forward: packed projections around the attention math
    (the flash kernel B9 under ``use_flash``). x: (B, T, d_model); ``valid``
    (B, T) marks the real tokens of a left-padded ragged batch."""

    def proj(name, inp):
        return _proj(packed, name, inp, cfg, compute_dtype, use_kernel)

    att = _attention_math(proj("wq", x), proj("wk", x), proj("wv", x), cfg,
                          use_flash=use_flash, valid=valid)
    return proj("wo", att)


def init_kv_cache(cfg: TernaryAttentionConfig, batch: int, max_len: int,
                  dtype=torch.float32, quantized: bool = False,
                  ragged: bool = False, device=None) -> dict:
    """Preallocated KV cache for incremental decode on ``device`` (None =
    the CUDA card), with ``pos``, the count of tokens written: flat
    (B, S, KVH·hd) ``k`` and ``v`` in ``dtype``, or with ``quantized`` the
    merged int8 layout of JAX (smmb_tpu/models/attention.py:327-352): one
    ``kv`` (B, S, 2·KVH·hd) int8 buffer with KV head h's k codes at slot 2h
    and its v codes at 2h+1, and one ``kv_scale`` (B, 2·KVH, S) f32 buffer
    of per-token absmax scales in the same interleave, stored transposed for
    the flash kernel's per-column reads. ``ragged`` adds the (B, max_len)
    bool ``valid`` mask of a left-padded ragged batch, all False until
    written."""
    from smmb_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    kvd = cfg.kv_heads * cfg.head_dim
    if quantized:
        cache = {
            "kv": torch.zeros((batch, max_len, 2 * kvd), dtype=torch.int8, device=dev),
            "kv_scale": torch.zeros((batch, 2 * cfg.kv_heads, max_len),
                                    dtype=torch.float32, device=dev),
            "pos": 0,
        }
    else:
        shape = (batch, max_len, kvd)
        cache = {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": 0,
        }
    if ragged:
        cache["valid"] = torch.zeros((batch, max_len), dtype=torch.bool, device=dev)
    return cache


# (…, hd) float → (int8 codes, f32 absmax/127 scale with hd → 1), B7's rule
_quantize_kv = fk.quantize_absmax


def _check_room(max_len: int, pos: int, c: int) -> None:
    # JAX's dynamic_update_slice clamps a write past max_len; the port raises
    if pos + c > max_len:
        raise ValueError(f"cache write at {pos} of {c} tokens exceeds max_len={max_len}")


def _write_valid(cache: dict, valid, pos: int, c: int) -> None:
    """A ragged cache's ``valid`` columns [pos, pos + C): ``valid`` (B, C)
    bool, or all real when None (decode and extend appends)."""
    if "valid" in cache:
        cache["valid"][:, pos:pos + c] = True if valid is None else valid


def _cache_write_quantized(cache: dict, kv_codes, kv_scales, pos: int,
                           valid=None) -> dict:
    """Write pre-quantized codes (B, C, 2·KVH·hd) int8 in the per-head
    [k|v] interleave and scales (B, 2·KVH, C) f32 at ``pos`` into the merged
    int8 cache, in place; returns the cache dict with ``pos`` advanced."""
    c = kv_codes.shape[1]
    _check_room(cache["kv"].shape[1], pos, c)
    cache["kv"][:, pos:pos + c] = kv_codes
    cache["kv_scale"][:, :, pos:pos + c] = kv_scales
    _write_valid(cache, valid, pos, c)
    return {**cache, "pos": pos + c}


def _cache_write(cache: dict, k, v, pos: int, valid=None) -> dict:
    """Write (B, C, KVH, hd) k/v at ``pos`` into the cache tensors in place
    (quantized first for an int8 cache: the prefill, rope and unfused
    routes); returns the cache dict with ``pos`` advanced by C. ``valid``
    (B, C) marks real tokens in a ragged cache (default: all real)."""
    b, c = k.shape[:2]
    if "kv" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        codes = torch.stack([kq, vq], dim=3).reshape(b, c, -1)
        scales = torch.stack([ks[..., 0], vs[..., 0]], dim=3).reshape(b, c, -1)
        return _cache_write_quantized(cache, codes, scales.transpose(1, 2), pos, valid)
    _check_room(cache["k"].shape[1], pos, c)
    cache["k"][:, pos:pos + c] = k.reshape(b, c, -1).to(cache["k"].dtype)
    cache["v"][:, pos:pos + c] = v.reshape(b, c, -1).to(cache["v"].dtype)
    _write_valid(cache, valid, pos, c)
    return {**cache, "pos": pos + c}


def _cache_kv(cache: dict, kv_heads: int):
    """The cache's K/V as (B, S, KVH, hd): views of a float cache, or the
    dequantized f32 copies of an int8 cache (the plain chunk math's input;
    the flash kernel B8 reads the codes instead)."""
    if "kv" in cache:
        b, s, kvd2 = cache["kv"].shape
        hd = kvd2 // (2 * kv_heads)
        kv = cache["kv"].view(b, s, kv_heads, 2, hd).to(torch.float32)
        sc = cache["kv_scale"].view(b, kv_heads, 2, s)
        ksc = sc[:, :, 0].transpose(1, 2)[..., None]  # (B, S, KVH, 1)
        vsc = sc[:, :, 1].transpose(1, 2)[..., None]
        return kv[:, :, :, 0] * ksc, kv[:, :, :, 1] * vsc
    b, s, kvd = cache["k"].shape
    hd = kvd // kv_heads
    return (cache["k"].view(b, s, kv_heads, hd),
            cache["v"].view(b, s, kv_heads, hd))


def _split_heads(x, cfg: TernaryAttentionConfig, heads: int | None = None):
    b, t, _ = x.shape
    return x.reshape(b, t, heads or cfg.n_heads, cfg.head_dim)


def attention_prefill(packed: dict, x: torch.Tensor, cache: dict,
                      cfg: TernaryAttentionConfig, *, compute_dtype=torch.float32,
                      use_kernel: bool = True, use_flash: bool = False, valid=None):
    """Whole prompt (B, T, D): full causal attention (as ``attention_forward``)
    plus the cache fill. ``use_flash`` runs the attention as B9. ``valid``
    (B, T): the real-token mask of a left-padded ragged batch (a ragged
    cache); pad slots are written and marked invalid. Returns (y, cache)."""
    b, t, _ = x.shape
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel)
    with span(ATTN_KV_FILL):
        k = _split_heads(_proj(packed, "wk", x, cfg, **kw), cfg, cfg.kv_heads)
        v = _split_heads(_proj(packed, "wv", x, cfg, **kw), cfg, cfg.kv_heads)
        pos = cache["pos"]
        if cfg.rope:
            k = apply_rope(k, _positions(pos, t, x.device), cfg.rope_theta)
        cache = _cache_write(cache, k, v, pos, valid)
    y = attention_forward(packed, x, cfg, use_flash=use_flash, valid=valid, **kw)
    return y, cache


def _chunk_attention_math(q, kc, vc, pos: int, head_dim: int, window=None,
                          valid=None):
    """C-token attention over a static-length cache: q (B, C, H, hd), kc/vc
    (B, max_len, KVH, hd) with the chunk already written at [pos, pos+C).
    Query row i attends cache columns ≤ pos+i (and > pos+i-window); the
    rest of the max_len buffer is masked with -inf, and every row sees its
    own token. A ragged cache's ``valid`` (B, max_len) masks its dead
    columns per row. Returns (B, C, H·hd) in the cache's dtype (the decode
    step is C=1)."""
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
    if valid is not None:
        live = live[None, None, None] & valid[:, None, None, None, :]
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
    return bool(
        use_kernel
        and packed.get("wqkv") is not None
        and not _has_lora(packed, ("wq", "wk", "wv"))
        and compute_dtype in fk.FLOAT_DTYPES
        and cfg.d_model % 512 == 0
        and packed["wqkv"].cols % 128 == 0
        and fk.fits_shared(cfg.d_model)
    )


def _proj_qkv_prenorm(packed, x, cfg, prenorm, compute_dtype):
    """norm1 + fused QKV in one kernel call (B3)."""
    lead = x.shape[:-1]
    y = fk.fused_norm_qkv(
        x.reshape(-1, x.shape[-1]), prenorm[0], packed["wqkv"],
        packed["qkv_scale"], packed["bqkv"], eps=prenorm[1],
        compute_dtype=compute_dtype,
    ).reshape(*lead, -1)
    d, kvd = cfg.q_dim, cfg.kv_dim
    return y[..., :d], y[..., d:d + kvd], y[..., d + kvd:]


def _qkv_quant_fusable(packed, cfg, compute_dtype, use_kernel) -> bool:
    """Can the int8 cache write ride B7's epilogue? JAX's conditions
    (smmb_tpu/models/attention.py:672-687): B3's, no rope (keys are cached
    roped, and the epilogue cannot rope) and head_dim % 128 == 0. Hopper
    limit: B7's block fits its shared memory (``fused_mlp.fits_shared_quant``),
    in place of JAX's 6 MiB VMEM cap on the plane."""
    return bool(
        _qkv_prenorm_fusable(packed, cfg, compute_dtype, use_kernel)
        and cfg.q_dim == cfg.d_model  # B7's q columns are its input's width
        and not cfg.rope
        and cfg.head_dim % 128 == 0
        and fk.fits_shared_quant(cfg.d_model, cfg.head_dim)
    )


def _proj_qkv_prenorm_quant(packed, x, cfg, prenorm, compute_dtype):
    """norm1 + fused QKV + the int8 quantize of K and V in one call (B7).
    x (B, C, D) → q (B, C, D), codes (B, C, 2·kv_dim) int8 and scales
    (B, 2·KVH, C) f32, shaped for ``_cache_write_quantized``."""
    b, c, _ = x.shape
    q, codes, scales = fk.fused_norm_qkv_quant(
        x.reshape(b * c, -1), prenorm[0], packed["wqkv"], packed["qkv_scale"],
        packed["bqkv"], eps=prenorm[1], d_model=cfg.d_model, kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim, compute_dtype=compute_dtype,
    )
    return (q.reshape(b, c, -1), codes.reshape(b, c, -1),
            scales.reshape(b, c, -1).transpose(1, 2))


def _cache_code_bytes(cache: dict) -> int:
    """Total k+v code bytes in the cache (the flash gate's size signal; the
    int8 cache's scales are not counted)."""
    if "kv" in cache:
        return cache["kv"].numel()
    return 2 * cache["k"].numel() * cache["k"].element_size()


def _flash_decode_ok(cache: dict, cfg: TernaryAttentionConfig, b: int,
                     use_flash: bool) -> bool:
    """JAX's decode gate (smmb_tpu/models/attention.py:774-787): ``use_flash``,
    no ragged ``valid`` mask, head_dim % 128 == 0, and batch 1, or an int8
    cache at any batch (the plain path would dequantize the whole cache), or
    [batch ≤ FLASH_DECODE_MAX_BATCH and a cache of at least
    FLASH_DECODE_MIN_CACHE_BYTES]."""
    return bool(
        use_flash
        and cache.get("valid") is None
        and cfg.head_dim % 128 == 0
        and (b == 1 or "kv" in cache
             or (b <= FLASH_DECODE_MAX_BATCH
                 and _cache_code_bytes(cache) >= FLASH_DECODE_MIN_CACHE_BYTES))
    )


def _flash_chunk_ok(cache: dict, cfg: TernaryAttentionConfig, c: int,
                    use_flash: bool) -> bool:
    """JAX's extend gate (smmb_tpu/models/attention.py:899-913): the decode
    gate's semantic conditions without the batch rule, and a chunk whose
    rows fit the kernel's block (``flash_decode.flash_chunk_rows_ok``, the
    card's shared memory in place of JAX's VMEM budget). The code buffer's
    width and itemsize go through as JAX passes them; the int8 cache's
    width is 2·KVH·hd, which the rows check reads as KVH heads."""
    code_buf = cache["kv"] if "kv" in cache else cache["k"]
    return bool(
        use_flash
        and cache.get("valid") is None
        and cfg.head_dim % 128 == 0
        and fd.flash_chunk_rows_ok(c, cfg.n_heads, cfg.head_dim, code_buf.shape[-1],
                                   code_buf.element_size())
    )


def _read_span(names, flash: bool, cache: dict) -> str:
    """A cache read's span name (``ATTN_DECODE`` or ``ATTN_EXTEND``) by its
    route: B4, B8 over an int8 cache, or the plain math."""
    return names[2] if not flash else names[1] if "kv" in cache else names[0]


def _step_qkv(packed, x, cache, cfg, compute_dtype, use_kernel, prenorm):
    """Q, K, V of a decode or extend step (B, C, ·) and the cache write:
    over an int8 cache under B7's gate, B7's codes go straight into the
    cache; otherwise the fused projection (with the norm inside B3 under
    ``prenorm``), rope at the cache position, and the write (quantized
    after the fact for an int8 cache). A ragged cache marks the written
    slots real. Returns (q (B, C, H, hd), cache)."""
    pos = cache["pos"]
    if (prenorm is not None and "kv" in cache
            and _qkv_quant_fusable(packed, cfg, compute_dtype, use_kernel)):
        with span(ATTN_QKV_B7):
            qf, codes, scales = _proj_qkv_prenorm_quant(packed, x, cfg, prenorm, compute_dtype)
            return _split_heads(qf, cfg), _cache_write_quantized(cache, codes, scales, pos)
    with span(ATTN_QKV_B1 if prenorm is None else ATTN_QKV_B3):
        if prenorm is not None:
            qf, kf, vf = _proj_qkv_prenorm(packed, x, cfg, prenorm, compute_dtype)
        else:
            qf, kf, vf = _proj_qkv(packed, x, cfg, compute_dtype, use_kernel)
        q = _split_heads(qf, cfg)
        k = _split_heads(kf, cfg, cfg.kv_heads)
        v = _split_heads(vf, cfg, cfg.kv_heads)
        if cfg.rope:
            at = _positions(pos, x.shape[1], x.device)
            q = apply_rope(q, at, cfg.rope_theta)
            k = apply_rope(k, at, cfg.rope_theta)
        return q, _cache_write(cache, k, v, pos)


def attention_decode_core(packed: dict, x_t: torch.Tensor, cache: dict,
                          cfg: TernaryAttentionConfig, *,
                          compute_dtype=torch.float32, use_kernel: bool = True,
                          use_flash: bool = False, prenorm=None):
    """``attention_decode_step`` without the output projection: returns the
    pre-``wo`` mix (B, 1, H·hd) and the cache. With ``prenorm=(g, eps)``,
    x_t is the raw residual stream and the RMSNorm runs inside B3 (the
    caller has checked ``_qkv_prenorm_fusable``; over an int8 cache the
    norm and the quantize ride B7 when ``_qkv_quant_fusable``). Under
    ``use_flash`` and JAX's gate (``_flash_decode_ok``) the cache read is
    the kernel B4, or B8 over an int8 cache."""
    b, one, _ = x_t.shape
    if one != 1:
        raise ValueError(f"decode step takes one token, got T={one}")
    pos = cache["pos"]
    q, cache = _step_qkv(packed, x_t, cache, cfg, compute_dtype, use_kernel, prenorm)
    flash = _flash_decode_ok(cache, cfg, b, use_flash)
    with span(_read_span(ATTN_DECODE, flash, cache)):
        if flash:
            if "kv" in cache:
                out = fd.flash_attention_decode_quant(
                    q[:, 0], cache["kv"], cache["kv_scale"], pos, window=cfg.window,
                    compute_dtype=compute_dtype)
            else:
                out = fd.flash_attention_decode(
                    q[:, 0], cache["k"], cache["v"], pos, window=cfg.window,
                    compute_dtype=compute_dtype)
            out = out.reshape(b, 1, -1)
        else:
            kc, vc = _cache_kv(cache, cfg.kv_heads)
            out = _chunk_attention_math(q, kc, vc, pos, cfg.head_dim, window=cfg.window,
                                        valid=cache.get("valid"))
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


def attention_extend_core(packed: dict, x: torch.Tensor, cache: dict,
                          cfg: TernaryAttentionConfig, *,
                          compute_dtype=torch.float32, use_kernel: bool = True,
                          use_flash: bool = False, prenorm=None):
    """``attention_extend`` without the output projection (the decode
    core's contract for a (B, C, D) chunk). Under ``use_flash`` and the
    chunk gate (``_flash_chunk_ok``) the cache read is B4's chunk entry (B8's
    over an int8 cache), so a token's row equals its decode step's bitwise.
    Returns the pre-``wo`` mix (B, C, H·hd) and the cache."""
    b, c, _ = x.shape
    pos = cache["pos"]
    q, cache = _step_qkv(packed, x, cache, cfg, compute_dtype, use_kernel, prenorm)
    flash = _flash_chunk_ok(cache, cfg, c, use_flash)
    with span(_read_span(ATTN_EXTEND, flash, cache)):
        if flash:
            if "kv" in cache:
                out = fd.flash_attention_chunk_quant(
                    q, cache["kv"], cache["kv_scale"], pos, window=cfg.window,
                    compute_dtype=compute_dtype)
            else:
                out = fd.flash_attention_chunk(
                    q, cache["k"], cache["v"], pos, window=cfg.window,
                    compute_dtype=compute_dtype)
            out = out.reshape(b, c, -1)
        else:
            kc, vc = _cache_kv(cache, cfg.kv_heads)
            out = _chunk_attention_math(q, kc, vc, pos, cfg.head_dim, window=cfg.window,
                                        valid=cache.get("valid"))
        return out, cache


def attention_extend(packed: dict, x: torch.Tensor, cache: dict,
                     cfg: TernaryAttentionConfig, *, compute_dtype=torch.float32,
                     use_kernel: bool = True, use_flash: bool = False):
    """Chunked prefill: append a (B, C, D) chunk at the cache position and
    attend each chunk token causally over everything cached so far; over
    chunks from an empty cache this is ``attention_prefill``'s result.
    Returns (y (B, C, D), cache)."""
    out, cache = attention_extend_core(
        packed, x, cache, cfg, compute_dtype=compute_dtype,
        use_kernel=use_kernel, use_flash=use_flash)
    return _proj(packed, "wo", out, cfg, compute_dtype, use_kernel), cache


def _chunked_step(qg, kb, vb, m, l, acc, start: int, causal: bool, window, scale: float):
    """One KV chunk of the online softmax: the carry (m, l, acc) in f32 after
    the keys ``start .. start + chunk``. Out of place throughout, so that the
    checkpoint's recompute finds every saved tensor as it was."""
    t, chunk = qg.shape[3], kb.shape[2]
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg.to(torch.float32),
                          kb.to(torch.float32)) * scale  # (B, KVH, G, T, chunk)
    if causal:
        q_pos = torch.arange(t, device=qg.device)[:, None]
        k_pos = torch.arange(start, start + chunk, device=qg.device)[None, :]
        live = q_pos >= k_pos
        if window is not None:
            # under causal only, as the serving math (QAT trains what serves)
            live = live & (q_pos - k_pos < window)
        scores = scores.masked_fill(~live, -1e30)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgqt,bktd->bkgqd", p, vb.to(torch.float32))
    return m_new, l, acc


def attention_math_chunked(q, k, v, cfg: TernaryAttentionConfig, chunk: int = 512):
    """Memory-efficient attention for long-context training (Rabe and
    Staats' recipe; the differentiable analog of the flash kernel).

    The same (B, T, D) → (B, T, D) contract as ``_attention_math``, but the
    (T, T) score tensor never exists: a loop over KV chunks carries the
    online softmax (m, l, acc) in f32, and each chunk's body runs under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``), so the backward
    recomputes a chunk's scores instead of storing them: O(T·chunk) memory
    forward and backward. Masked scores are −1e30, as in JAX.
    """
    b, t, d = q.shape
    h, hd, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    g = h // kvh
    if t % chunk:
        raise ValueError(f"T={t} % chunk={chunk} != 0")
    q, k = _rope_qk(q, k, cfg, _positions(0, t, q.device))
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, t, kvh, g, hd).permute(0, 2, 3, 1, 4)
    kh = k.reshape(b, t, kvh, hd).permute(0, 2, 1, 3)
    vh = v.reshape(b, t, kvh, hd).permute(0, 2, 1, 3)
    m = torch.full((b, kvh, g, t), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, t, hd), dtype=torch.float32, device=q.device)
    for start in range(0, t, chunk):
        m, l, acc = checkpoint(
            _chunked_step, qg, kh[:, :, start:start + chunk], vh[:, :, start:start + chunk],
            m, l, acc, start, cfg.causal, cfg.window, scale, use_reentrant=False)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, d).to(q.dtype)


def qat_attention_forward(params: dict, x: torch.Tensor, cfg: TernaryAttentionConfig,
                          attn_chunk: int | None = None) -> torch.Tensor:
    """Training forward on the masters: STE-ternarized dense projections
    (differentiable) around the plain attention math, mirroring the serving
    math as ``train.qat_forward`` does; ``attn_chunk`` switches to
    ``attention_math_chunked`` for long contexts. Never the flash kernel."""

    def proj(name, inp):
        return qat_linear(inp, params[name], params[name.replace("w", "b")])

    q, k, v = proj("wq", x), proj("wk", x), proj("wv", x)
    if attn_chunk is None:
        att = _attention_math(q, k, v, cfg, use_flash=False)
    else:
        att = attention_math_chunked(q, k, v, cfg, chunk=attn_chunk)
    return proj("wo", att)
