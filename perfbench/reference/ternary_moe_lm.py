"""Plain PyTorch reference of the routed ternary LM, in float32 with TF32 off.

A frozen statement of the model's mathematics, independent of the program:
it imports nothing of the port, draws the masters again from the run's seed
(``perfbench/inputs/ternary_moe_lm.py``) and serves each projection as
``x·(s·T) + b``, the absmean ternarisation of its master (one scale an
expert matrix). It runs layer by layer over all the sequences it is given
(one layer's weights alive at a time) and attention in blocks of query
rows, each block over the keys its window reaches, so that it fits beside
nothing else on the card once the program's state is freed.

A block: RMSNorm; Q, K, V (Q n_heads·head_dim wide, K and V over the KV
heads), RoPE at theta on Q and K, causal attention cut to the layer's window
(query t attends keys t − window < s ≤ t; every earlier key in a full
layer), ``wo``; the residual add; RMSNorm; the router's f32 logits
(``h @ router`` in f32, the reference's own), softmax gates, the k largest
(the lower expert first among equal gates) renormalised over the k, each
chosen expert's ungated PReLU FFN, the terms summed; the residual add.
Departures from Mellum2 are the configuration's ``departures``, each marked
where it is computed.

``rounding`` names a lower-precision dtype (``"float8_e4m3fn"``): every
tensor is then rounded to it wherever the program rounds its bf16
activations (the stream after each add, each norm, projection, rope and
attention output, each expert's input and output, the logits): the cell's
control.
"""

from __future__ import annotations

import math

import torch

from perfbench.counts.ternary_moe_lm import ATTN_KINDS, dims
from perfbench.inputs import ternary_moe_lm as inputs
from perfbench.reference.ternary_lm import _rounder, absmean_weight, f32_mode, rmsnorm, rope

Q_BLOCK = 512  # query rows of one block of the attention


def windowed_attention(q, k, v, window: int | None, q_block: int = Q_BLOCK) -> torch.Tensor:
    """q (B, T, H, hd), k and v (B, T, KVH, hd); query head h reads KV head
    h // (H / KVH); query t attends keys max(0, t − window + 1) .. t (0 .. t
    without a window), scaled by 1/sqrt(hd). Returns (B, T, H·hd)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    out = torch.empty(b, t, h, hd, dtype=torch.float32, device=q.device)
    for t0 in range(0, t, q_block):
        t1 = min(t, t0 + q_block)
        k0 = 0 if window is None else max(0, t0 - window + 1)
        qb = q[:, t0:t1].reshape(b, t1 - t0, kvh, g, hd)
        s = torch.einsum("bqkgd,btkd->bkgqt", qb, k[:, k0:t1]) / math.sqrt(hd)
        rows = torch.arange(t0, t1, device=q.device)[:, None]
        cols = torch.arange(k0, t1, device=q.device)[None, :]
        live = cols <= rows
        if window is not None:
            live = live & (cols > rows - window)
        p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
        o = torch.einsum("bkgqt,btkd->bqkgd", p, v[:, k0:t1])
        out[:, t0:t1] = o.reshape(b, t1 - t0, h, hd)
    return out.reshape(b, t, h * hd)


def expert_weights(w: torch.Tensor) -> torch.Tensor:
    """(E, K, N) masters → each expert's served ``s_e·T_e``, f32."""
    s = w.abs().mean(dim=(1, 2), keepdim=True) + 1e-8
    return torch.clamp(torch.round(w / s), -1.0, 1.0) * s


def routed(h: torch.Tensor, moe: dict, up, down, dm: dict, r) -> torch.Tensor:
    """The routed half on (N, D) rows: each row through its top_k experts,
    weighted by its renormalised gates."""
    gates = torch.softmax(h @ moe["router"], dim=-1)
    srt = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_v, top_i = srt.values[:, :dm["top_k"]], srt.indices[:, :dm["top_k"]]
    top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(dm["n_experts"]):
        hit = top_i == e
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        weight = (top_v * hit).sum(dim=-1)[rows, None]
        # departure: an ungated PReLU expert of two matrices (Mellum2: SiLU-gated, three)
        u = h[rows] @ up[e] + moe["b_up"][e]
        u = torch.where(u > 0, u, dm["alpha"] * u)
        y.index_add_(0, rows, weight * r(r(u) @ down[e] + moe["b_down"][e]))
    return y


def block(x: torch.Tensor, m: dict, w: dict, up, down, dm: dict, window, r) -> torch.Tensor:
    """One pre-norm block: x + attn(norm1(x)), then x + moe(norm2(x))."""
    b, t, d = x.shape
    h_, kvh, hd = dm["n_heads"], dm["n_kv_heads"], dm["head_dim"]
    a = m["attn"]
    h = r(rmsnorm(x, m["norm1"], dm["eps"]))
    # departure: biases on every projection (Mellum2: attention_bias false)
    q = r(h @ w["wq"] + a["bq"]).view(b, t, h_, hd)
    k = r(h @ w["wk"] + a["bk"]).view(b, t, kvh, hd)
    v = r(h @ w["wv"] + a["bv"]).view(b, t, kvh, hd)
    # departure: plain RoPE at theta on every layer (Mellum2's full layers: YaRN)
    pos = torch.arange(t, device=x.device)
    q, k = r(rope(q, pos, dm["rope_theta"])), r(rope(k, pos, dm["rope_theta"]))
    x = r(x + r(r(windowed_attention(q, k, v, window)) @ w["wo"] + a["bo"]))
    h = r(rmsnorm(x, m["norm2"], dm["eps"]))
    y = routed(h.reshape(b * t, d), m["moe"], up, down, dm, r).reshape(b, t, d)
    return r(x + r(y))


@torch.no_grad()
def logits(cfg: dict, seed: int, groups: list, dev, rounding: str | None = None) -> list:
    """The f32 logits of each group: ``groups`` holds dicts with ``tokens``
    (B, T) int64 and ``positions`` (the positions whose logits are wanted).
    Returns one (B, len(positions), vocab) tensor a group."""
    f32_mode()
    r = _rounder(rounding)
    dm = dims(cfg)
    dense = inputs.dense_leaves(cfg, seed, dev, dm["max_len"])
    # departure: a learned position table added to the embedding, beside RoPE
    xs = [r(dense["embed"][g["tokens"]].to(torch.float32)
            + dense["pos"][:g["tokens"].shape[1]].to(torch.float32)[None]) for g in groups]
    for layer, window in enumerate(dm["windows"]):
        m = inputs.block_masters(cfg, seed, layer, dev)
        w = {kind: absmean_weight(m["attn"][kind]) for kind in ATTN_KINDS}
        up, down = expert_weights(m["moe"]["w_up"]), expert_weights(m["moe"]["w_down"])
        xs = [block(x, m, w, up, down, dm, window, r) for x in xs]
        del m, w, up, down
    # departure: a ternary head (Mellum2: an untied bf16 head); no MTP head
    head = absmean_weight(inputs.head_master(cfg, seed, dev))
    out = []
    for x, g in zip(xs, groups):
        h = r(rmsnorm(x[:, g["positions"]], dense["norm_f"], dm["eps"]))
        out.append(r(h @ head))
    return out
