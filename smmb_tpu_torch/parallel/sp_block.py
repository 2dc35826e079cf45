"""Sequence-parallel transformer block and LM forward (counterpart of
smmb_tpu/parallel/sp_block.py).

The sp column above the attention layer (parallel/ring_attention.py): the
whole block — norms, ternary projections, MLP or routed MoE FFN — is
per-token work on the rank's T/model chunk, so the only collectives are the
ring's s − 1 KV shifts a block. Activation memory a rank is
O(B·T/model·D): a context model times longer fits the same card.

Weights are whole on every rank (2-bit planes; replicating them is cheaper
than the collectives a weight split would add to every token), and every
projection is B1 on the rank's tokens. An MoE block's FFN is the port's
``moe_forward(no_drop=True)`` on the rank's tokens: routing is per token,
so each chunk routes its own, drop-free, as the single-rank block does.

Tensors in and out are the rank's chunks (``ring_attention.local_seq``
cuts them, and refuses a T that does not divide by model). This is the
long-context prefill path; decode serves from models/lm.generate.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.models.moe import moe_forward
from smmb_tpu_torch.models.transformer import rmsnorm
from smmb_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from smmb_tpu_torch.parallel.ring_attention import _proj, _reject_lora_sp, _ring_body
from smmb_tpu_torch.parallel.sharded import _local_spmm


def _check_sp(packed: dict) -> None:
    """The SP path serves unadapted blocks only (JAX's refusal)."""
    _reject_lora_sp(packed)
    _reject_lora_sp(packed["attn"])


def _block_body_sp(d: dict, x_l: torch.Tensor, cfg, mesh: Mesh, compute_dtype,
                   use_kernel: bool) -> torch.Tensor:
    """The rank's block: everything on its own tokens except the KV ring."""
    bl, tl, dm = x_l.shape
    a = d["attn"]
    acfg = cfg.attn
    hd = acfg.head_dim
    h = rmsnorm(x_l, d["norm1"], cfg.eps)
    q = _proj(a, "wq", h, compute_dtype, use_kernel).reshape(bl, tl, acfg.n_heads, hd)
    k = _proj(a, "wk", h, compute_dtype, use_kernel).reshape(bl, tl, acfg.kv_heads, hd)
    v = _proj(a, "wv", h, compute_dtype, use_kernel).reshape(bl, tl, acfg.kv_heads, hd)
    att = _ring_body(q, k, v, mesh, cfg.causal, acfg.rope_theta if acfg.rope else None,
                     acfg.window)
    x_l = x_l + _proj(a, "wo", att.reshape(bl, tl, -1), compute_dtype,
                      use_kernel).reshape(bl, tl, dm)
    h2 = rmsnorm(x_l, d["norm2"], cfg.eps).reshape(bl * tl, dm)
    if "moe" in d:
        y = moe_forward(d["moe"], h2, cfg.moe, compute_dtype=compute_dtype,
                        use_kernel=use_kernel, no_drop=True)
        return x_l + y.reshape(bl, tl, dm)
    up = _local_spmm(h2 * d["s_up"], d["w_up"], d["b_up"], cfg.alpha, compute_dtype,
                     use_kernel)
    down = _local_spmm(up * d["s_down"], d["w_down"], d["b_down"], None, compute_dtype,
                       use_kernel)
    return x_l + down.reshape(bl, tl, dm)


def block_forward_sp(packed: dict, x: torch.Tensor, cfg, *, mesh: Mesh,
                     compute_dtype=torch.float32, use_kernel: bool = True) -> torch.Tensor:
    """Sequence-parallel block forward (dense or MoE block): x (B_local,
    T_local, d_model), the rank's chunk; returns y likewise."""
    _check_sp(packed)
    return _block_body_sp(packed, x, cfg, mesh, compute_dtype, use_kernel)


def lm_forward_sp(packed: dict, tokens: torch.Tensor, cfg, *, mesh: Mesh,
                  compute_dtype=torch.float32, use_kernel: bool = True) -> torch.Tensor:
    """Sequence-parallel LM forward: the rank's (B_local, T_local) token
    chunk → its (B_local, T_local, vocab) logits. The learned positions are
    the chunk's global ones, rows ``[r·T_local, (r+1)·T_local)`` of the
    table for model rank r; embedding, norms and the head (B1, in f32 on
    the plain path as the single-rank head) run on the rank's tokens."""
    for blk in packed["blocks"]:
        _check_sp(blk)
    bl, tl = tokens.shape
    s, r = mesh.axis_size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    if s * tl > cfg.max_len:
        raise ValueError(f"T={s * tl} exceeds max_len={cfg.max_len}")
    x = packed["embed"][tokens] + packed["pos"][r * tl:(r + 1) * tl][None]
    for blk in packed["blocks"]:
        x = _block_body_sp(blk, x, cfg.block, mesh, compute_dtype, use_kernel)
    h = rmsnorm(x, packed["norm_f"], cfg.eps)
    y = _local_spmm(h.reshape(bl * tl, -1), packed["head"], None, None,
                    compute_dtype if use_kernel else torch.float32, use_kernel)
    return (y * packed["head_scale"]).reshape(bl, tl, cfg.vocab)
