"""Plain PyTorch reference of the ternary MoE LM with a window a layer, in
float32 with TF32 off.

The model's mathematics written out once more, independent of the program:
plain ``torch`` operations on the masters tree of ``models/lm.py``'s
``init_lm`` (read as dicts of tensors; nothing of the port is imported),
with no kernel, cache or batching. Every projection is served as the
absmean ternarisation of its master, ``x·(s·T) + b`` with
``s = mean|W| + 1e-8`` and ``T = clip(round(W / s), -1, 1)`` (the head
without a bias); each block is pre-norm (RMSNorm with gain), attention with
grouped KV heads of width ``head_dim`` (Q ``n_heads·head_dim`` wide, apart
from ``d_model``), rotate-half RoPE, a causal mask cut to the layer's
window (query t attends keys t − window < s ≤ t, or every earlier key),
then the routed experts: f32 router logits, softmax gates, the k largest
(the lower expert first among equal gates), renormalised over the k for
k > 1 (the raw gate at k = 1), each expert an ungated PReLU FFN, the terms
summed. Token embedding plus a learned position table in front, a final
RMSNorm and the head behind.

``rounding`` (a dtype such as ``torch.float16``) rounds every activation
where a lower-precision program would: a test's proof that its tolerance
would catch a program computing below f32.
"""

from __future__ import annotations

import math

import torch


def _f32_mode() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def absmean_weight(w: torch.Tensor) -> torch.Tensor:
    """The served weight ``s·T`` of a master, f32."""
    w = w.to(torch.float32)
    s = w.abs().mean() + 1e-8
    return torch.clamp(torch.round(w / s), -1.0, 1.0) * s


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g.to(torch.float32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (B, T, H, hd) at positions 0..T−1, the two halves
    of a head paired."""
    t, half = x.shape[1], x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32) / half)
    ang = torch.arange(t, dtype=torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: int | None) -> torch.Tensor:
    """q (B, T, H, hd), k and v (B, T, KVH, hd); query head h reads KV head
    h // (H / KVH). Returns (B, T, H·hd)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    qi = torch.arange(t)[:, None]
    ki = torch.arange(t)[None, :]
    live = ki <= qi
    if window is not None:
        live = live & (ki > qi - window)
    p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, h * hd)


def routed_experts(h: torch.Tensor, m: dict, top_k: int, alpha: float, r) -> torch.Tensor:
    """The routed half on (N, D) rows: every expert on every row, each term
    weighted by the row's gate for that expert (zero where not chosen)."""
    gates = torch.softmax(h @ m["router"].to(torch.float32), dim=-1)
    srt = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_v, top_i = srt.values[:, :top_k], srt.indices[:, :top_k]
    if top_k > 1:
        top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(m["w_up"].shape[0]):
        weight = (top_v * (top_i == e)).sum(dim=-1, keepdim=True)
        u = h @ absmean_weight(m["w_up"][e]) + m["b_up"][e]
        u = torch.where(u > 0, u, alpha * u)
        y = y + weight * r(r(u) @ absmean_weight(m["w_down"][e]) + m["b_down"][e])
    return y


@torch.no_grad()
def logits(params: dict, tokens: torch.Tensor, cfg, rounding=None) -> torch.Tensor:
    """(B, T) tokens → (B, T, vocab) f32 logits of the masters ``params``
    under ``cfg`` (a ``TernaryLMConfig`` with ``n_experts``, read by
    attribute: ``n_heads``, ``n_kv_heads``, ``head_dim``, ``layer_windows``
    or ``window``, ``top_k``, ``alpha``, ``eps``, ``rope``, ``rope_theta``)."""
    _f32_mode()
    r = (lambda t: t) if rounding is None else (lambda t: t.to(rounding).to(torch.float32))
    b, t = tokens.shape
    h_, kvh = cfg.n_heads, cfg.n_kv_heads or cfg.n_heads
    hd = cfg.head_dim or cfg.d_model // h_
    windows = cfg.layer_windows or (cfg.window,) * len(params["blocks"])
    x = r(params["embed"][tokens].to(torch.float32)
          + params["pos"][:t].to(torch.float32)[None])
    for blk, window in zip(params["blocks"], windows):
        a = blk["attn"]
        h = r(rmsnorm(x, blk["norm1"], cfg.eps))

        def proj(name, inp):
            return r(inp @ absmean_weight(a[name]) + a["b" + name[1:]])

        q = proj("wq", h).view(b, t, h_, hd)
        k = proj("wk", h).view(b, t, kvh, hd)
        v = proj("wv", h).view(b, t, kvh, hd)
        if cfg.rope:
            q, k = r(rope(q, cfg.rope_theta)), r(rope(k, cfg.rope_theta))
        x = r(x + proj("wo", r(attention(q, k, v, window))))
        h = r(rmsnorm(x, blk["norm2"], cfg.eps))
        y = routed_experts(h.reshape(b * t, -1), blk["moe"], cfg.top_k, cfg.alpha, r)
        x = r(x + r(y.reshape(b, t, -1)))
    h = r(rmsnorm(x, params["norm_f"], cfg.eps))
    return r(h @ absmean_weight(params["head"]))
