"""Weights and prompts of the routed ternary LM, made on the device from the
run's seed, layer by layer: one generator a layer, seeded from the run's
seed and the layer's index, so the program packs a layer and drops its
masters before the next is drawn, and the reference draws each layer again
alone.

Masters follow the port's MoE block layout (``init_moe_block``'s tree) at
the configuration's widths: attention projections ``wq`` (d, H·hd), ``wk``
and ``wv`` (d, KVH·hd), ``wo`` (H·hd, d); the router (d, E) in f32; the
experts stacked, ``w_up`` (E, d, F) and ``w_down`` (E, F, d). Each ternary
master is a draw with P(+1) = P(-1) = 1/(2·non_zero) over sqrt(fan_in);
biases uniform in [-1, 1) over sqrt(fan_in), f32; the router uniform in
[-1, 1) times ``router_gain`` over sqrt(d). Embedding, position table,
final norm, head and prompts are the ternary LM's (``inputs/ternary_lm.py``)
at these sizes.
"""

from __future__ import annotations

import math

import torch

from perfbench.counts.ternary_moe_lm import attn_shapes, dims, expert_shapes
from perfbench.inputs import ternary_lm
from perfbench.inputs.ternary_lm import _gen, master_scale, ternary


def _uniform(g, shape, dev) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=dev) * 2.0 - 1.0


def block_masters(cfg: dict, seed: int, layer: int, dev) -> dict:
    """Layer ``layer``'s masters in the port's MoE block layout."""
    dm = dims(cfg)
    g = _gen(dev, seed, "moe-block", layer)
    nz = dm["non_zero"]
    attn = {}
    for kind, (k, n) in attn_shapes(dm).items():
        attn[kind] = ternary(torch.rand(k * n, generator=g, device=dev), nz).view(k, n) \
            * master_scale(cfg, k)
        attn["b" + kind[1:]] = _uniform(g, n, dev) / math.sqrt(k)
    e, d = dm["n_experts"], dm["d_model"]
    moe = {"router": _uniform(g, (d, e), dev) * (cfg["router_gain"] / math.sqrt(d))}
    for kind, (k, n) in expert_shapes(dm).items():
        moe[kind] = ternary(torch.rand(e * k * n, generator=g, device=dev), nz).view(e, k, n) \
            * master_scale(cfg, k)
        moe["b" + kind[1:]] = _uniform(g, (e, n), dev) / math.sqrt(k)
    ones = torch.ones(d, dtype=torch.bfloat16, device=dev)
    return {"attn": attn, "moe": moe, "norm1": ones, "norm2": ones.clone()}


def dense_leaves(cfg: dict, seed: int, dev, max_len: int) -> dict:
    return ternary_lm.dense_leaves(dims(cfg), seed, dev, max_len)


def head_master(cfg: dict, seed: int, dev) -> torch.Tensor:
    return ternary_lm.head_master(dims(cfg), seed, dev)


def prompts(cfg: dict, seed: int, tag: str, index: int, batch: int, length: int,
            dev) -> torch.Tensor:
    return ternary_lm.prompts(dims(cfg), seed, tag, index, batch, length, dev)
