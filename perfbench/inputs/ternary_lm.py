"""Weights and prompts of the ternary LM, made on the device from the run's
seed. The program and the reference are handed the same values: the
program's set-up packs them, the reference derives its own f32 weights from
them (so each draw is reproducible alone: one generator a layer, seeded
from the run's seed and the layer's index).

Masters follow the port's parameter layout (``init_lm``'s tree). Each
projection's master is a ternary draw, P(+1) = P(-1) = 1/(2·non_zero),
times 1/sqrt(fan_in) (LeCun scale, ``master_scale``); served through
``quantize=True`` its absmean ternarisation gives back the draw's signs
and the scale mean|W|. Biases are uniform in [-1, 1) over sqrt(fan_in),
in f32 as the kernels add them. The embedding and position tables are
uniform in [-1, 1) and the norm gains 1, in bfloat16, the type they are
served in, so that the residual stream is bfloat16.
"""

from __future__ import annotations

import math

import torch

from perfbench.counts.ternary_lm import shapes
from perfbench.lib.seeds import derive


def _gen(dev, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(derive(seed, *tags))


def ternary(u: torch.Tensor, non_zero: int) -> torch.Tensor:
    """Uniform draws in [0, 1) → {-1, 0, +1} with P(±1) = 1/(2·non_zero)."""
    p = 1.0 / (2 * non_zero)
    return (u >= 1.0 - p).to(torch.float32) - (u < p).to(torch.float32)


def master_scale(cfg: dict, fan_in: int) -> float:
    if cfg["master_scale"] != "lecun":
        raise ValueError(f"unknown master_scale {cfg['master_scale']!r}")
    return 1.0 / math.sqrt(fan_in)


def block_masters(cfg: dict, seed: int, layer: int, dev) -> dict:
    """Layer ``layer``'s masters in the port's block layout, in a few large
    draws from the layer's own generator."""
    g = _gen(dev, seed, "lm-block", layer)
    shp = shapes(cfg)
    u = torch.rand(sum(k * n for k, n in shp.values()), generator=g, device=dev)
    bias = torch.rand(sum(n for _, n in shp.values()), generator=g, device=dev) * 2.0 - 1.0
    attn, blk = {}, {}
    off = boff = 0
    for kind, (k, n) in shp.items():
        w = ternary(u[off:off + k * n], cfg["non_zero"]).view(k, n) * master_scale(cfg, k)
        b = bias[boff:boff + n] / math.sqrt(k)
        off, boff = off + k * n, boff + n
        tree = attn if kind in ("wq", "wk", "wv", "wo") else blk
        tree[kind] = w
        tree["b" + kind[1:]] = b  # wq → bq, w_up → b_up
    ones = torch.ones(cfg["d_model"], dtype=torch.bfloat16, device=dev)
    return {"attn": attn, **blk, "norm1": ones, "norm2": ones.clone()}


def dense_leaves(cfg: dict, seed: int, dev, max_len: int) -> dict:
    """Embedding, position table (its first ``max_len`` rows) and final norm
    gain, bfloat16."""
    g = _gen(dev, seed, "lm-dense")
    d = cfg["d_model"]
    embed = (torch.rand(cfg["vocab"], d, generator=g, device=dev) * 2.0 - 1.0)
    pos = torch.rand(cfg["max_len"], d, generator=g, device=dev) * 2.0 - 1.0
    return {"embed": embed.to(torch.bfloat16), "pos": pos[:max_len].to(torch.bfloat16),
            "norm_f": torch.ones(d, dtype=torch.bfloat16, device=dev)}


def head_master(cfg: dict, seed: int, dev) -> torch.Tensor:
    g = _gen(dev, seed, "lm-head")
    d, v = cfg["d_model"], cfg["vocab"]
    u = torch.rand(d * v, generator=g, device=dev)
    return ternary(u, cfg["non_zero"]).view(d, v) * master_scale(cfg, d)


def prompts(cfg: dict, seed: int, tag: str, index: int, batch: int, length: int,
            dev) -> torch.Tensor:
    """(batch, length) int64 tokens, uniform over the vocabulary, for the
    ``index``-th request or batch of the stream ``tag``."""
    g = _gen(dev, seed, "prompt", tag, index)
    return torch.randint(0, cfg["vocab"], (batch, length), generator=g, device=dev)
