"""Plain PyTorch reference of the ternary LM, in float32 with TF32 off.

A frozen statement of the model's mathematics, independent of the program:
it imports nothing of the port, draws the masters again from the run's seed
(``perfbench/inputs/ternary_lm.py``) and derives its own weights from them
by absmean ternarisation, ``T = clip(round(W / s), -1, 1)`` with
``s = mean|W| + 1e-8``, each projection ``x·(s·T) + b``. It runs layer by
layer over all the sequences it is given (one layer's weights alive at a
time) and attention in blocks of query rows, so that it fits beside nothing
else on the card once the program's state is freed.

The block is the port's and departs from BitNet b1.58 2B-4T where the
config's ``departures`` say; each departure is marked where it is computed.

``rounding`` names a lower-precision dtype (``"float8_e4m3fn"``): every
tensor is then rounded to it wherever the program rounds its bf16
activations (the stream after each add, each norm, projection, rope and
attention output, the logits). That is the cell's control: the reference
put in the program's place one precision below the configuration's.
"""

from __future__ import annotations

import math

import torch

from perfbench.counts.ternary_lm import shapes
from perfbench.inputs import ternary_lm as inputs

Q_BLOCK = 512  # query rows of one block of the attention


def f32_mode() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def absmean_weight(w: torch.Tensor) -> torch.Tensor:
    """The served weight ``s·T`` of a master, f32."""
    s = w.abs().mean() + 1e-8
    return torch.clamp(torch.round(w / s), -1.0, 1.0) * s


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g.to(torch.float32)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (B, T, H, hd), the two halves of a head paired
    (the rotate-half form)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, q_block: int = Q_BLOCK) -> torch.Tensor:
    """q (B, T, H, hd), k and v (B, T, KVH, hd); query head h reads KV head
    h // (H / KVH). Softmax over the keys up to each query's own position,
    scaled by 1/sqrt(hd). Returns (B, T, H·hd)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    out = torch.empty(b, t, h, hd, dtype=torch.float32, device=q.device)
    cols = torch.arange(t, device=q.device)
    for t0 in range(0, t, q_block):
        t1 = min(t, t0 + q_block)
        qb = q[:, t0:t1].reshape(b, t1 - t0, kvh, g, hd)
        s = torch.einsum("bqkgd,btkd->bkgqt", qb, k[:, :t1]) / math.sqrt(hd)
        live = cols[None, :t1] <= torch.arange(t0, t1, device=q.device)[:, None]
        s = s.masked_fill(~live, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,btkd->bqkgd", p, v[:, :t1])
        out[:, t0:t1] = o.reshape(b, t1 - t0, h, hd)
    return out.reshape(b, t, h * hd)


def _rounder(rounding: str | None):
    if rounding is None:
        return lambda t: t
    dt = getattr(torch, rounding)
    return lambda t: t.to(dt).to(torch.float32)


def block(x: torch.Tensor, m: dict, w: dict, cfg: dict, r=lambda t: t) -> torch.Tensor:
    """One pre-norm block: x + attn(norm1(x)), then x + mlp(norm2(x)); ``r``
    rounds where the program rounds its activations."""
    b, t, d = x.shape
    h_, kvh = cfg["n_heads"], cfg["n_kv_heads"]
    hd = d // h_
    a = m["attn"]
    h = r(rmsnorm(x, m["norm1"], cfg["eps"]))
    q = r(h @ w["wq"] + a["bq"]).view(b, t, h_, hd)
    k = r(h @ w["wk"] + a["bk"]).view(b, t, kvh, hd)
    v = r(h @ w["wv"] + a["bv"]).view(b, t, kvh, hd)
    if cfg["rope"]:
        pos = torch.arange(t, device=x.device)
        q, k = r(rope(q, pos, cfg["rope_theta"])), r(rope(k, pos, cfg["rope_theta"]))
    x = r(x + r(r(causal_attention(q, k, v)) @ w["wo"] + a["bo"]))
    h = r(rmsnorm(x, m["norm2"], cfg["eps"]))
    # departure: an ungated PReLU MLP of two matrices (BitNet: gated ReLU², three)
    # departure: no SubLN before the down projection
    u = h @ w["w_up"] + m["b_up"]
    u = r(torch.where(u > 0, u, cfg["alpha"] * u))
    return r(x + r(u @ w["w_down"] + m["b_down"]))


@torch.no_grad()
def logits(cfg: dict, seed: int, groups: list, dev, rounding: str | None = None) -> list:
    """The f32 logits of each group: ``groups`` holds dicts with ``tokens``
    (B, T) int64 and ``positions`` (the positions whose logits are wanted).
    Returns one (B, len(positions), vocab) tensor a group."""
    f32_mode()
    r = _rounder(rounding)
    dense = inputs.dense_leaves(cfg, seed, dev, cfg["max_len"])
    # departure: a learned position table added to the embedding, beside RoPE
    xs = [r(dense["embed"][g["tokens"]].to(torch.float32)
            + dense["pos"][:g["tokens"].shape[1]].to(torch.float32)[None]) for g in groups]
    for layer in range(cfg["n_layers"]):
        m = inputs.block_masters(cfg, seed, layer, dev)
        w = {kind: absmean_weight(m["attn"][kind] if kind in m["attn"] else m[kind])
             for kind in shapes(cfg)}
        xs = [block(x, m, w, cfg, r) for x in xs]
        del m, w
    # departure: a separate ternary head in place of the tied embedding
    head = absmean_weight(inputs.head_master(cfg, seed, dev))
    out = []
    for x, g in zip(xs, groups):
        h = r(rmsnorm(x[:, g["positions"]], dense["norm_f"], cfg["eps"]))
        out.append(r(h @ head))
    return out
