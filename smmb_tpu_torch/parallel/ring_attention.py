"""Sequence-parallel ring attention over the process mesh (counterpart of
smmb_tpu/parallel/ring_attention.py).

Long-context prefill shards the *sequence* axis: model rank r holds the
r-th chunk of T/model tokens. The Q/K/V projections are per-token work
(B1 on the rank's tokens); attention runs as a ring: each rank keeps its Q
chunk fixed while the (K, V) chunks travel round the ``model`` line, one
``ring_shift`` a step (K and V packed into one buffer, so one send/receive
a step), and folds each chunk into an online softmax (running max,
denominator and numerator, in f32). The next chunk's transfer is started
before the fold of the chunk in hand and waited for after it. s − 1 shifts
in all: the last chunk held is folded without a further rotation.

Positions are global: rank r's queries sit at ``r·T_local + i``. The causal
mask, the sliding window and RoPE (applied by every rank to its own chunk
before the ring, so the travelling keys arrive rotated) all use them.
Masked scores take the finite ``_NEG`` (never −inf), so the online update
never forms exp(−inf − −inf).

The math is JAX's plain einsums, in f32 with TF32 off (JAX's
``Precision.HIGHEST``), grouped-query heads kept as (B, Tq, KVH, G, hd),
never expanded to H. No kernel runs here: the ring is not a Pallas kernel
in JAX either.
"""

from __future__ import annotations

import math

import torch

from smmb_tpu_torch.models.attention import apply_rope
from smmb_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, ring_shift_start
from smmb_tpu_torch.parallel.sharded import _local_spmm

_NEG = -1e30  # finite mask value: exp(_NEG - m) underflows to 0 cleanly


def local_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's chunk of a global ``x`` (B_local, T, ...) sequence-sharded
    over ``model`` (axis 1; JAX's ``P(DATA_AXIS, MODEL_AXIS, ...)``):
    tokens ``[r·T/model, (r+1)·T/model)`` of model rank r."""
    s = mesh.axis_size(MODEL_AXIS)
    t = x.shape[1]
    if t % s:
        raise ValueError(f"T={t} % model={s} != 0")
    tl = t // s
    r = mesh.index(MODEL_AXIS)
    return x[:, r * tl:(r + 1) * tl]


def _ring_body(q, k, v, mesh: Mesh, causal: bool, rope_theta=None, window=None):
    """The rank's online-softmax ring: q fixed, (k, v) rotate s − 1 times.

    q (B, Tq, H, hd) is the rank's query chunk, k and v (B, Tk, KVH, hd) its
    key and value chunks (KVH < H: grouped-query attention). ``rope_theta``
    ropes q and k at the chunk's global positions first.
    Returns (B, Tq, H, hd) in q's dtype."""
    b, tq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    s = mesh.axis_size(MODEL_AXIS)
    me = mesh.index(MODEL_AXIS)
    dev = q.device
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    q_pos = me * tq + torch.arange(tq, device=dev)  # global positions of my queries
    if rope_theta is not None:
        q = apply_rope(q, q_pos, rope_theta)
        k = apply_rope(k, q_pos, rope_theta)  # my chunk: the same positions
    qg = q.reshape(b, tq, kvh, g, hd).to(torch.float32)
    m = torch.full((b, kvh, g, tq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, tq, hd), dtype=torch.float32, device=dev)

    def fold(kv, m, l, acc, i):
        src = (me - i) % s  # ring owner of the chunk in hand
        kc, vc = kv[..., :hd], kv[..., hd:]
        tk = kc.shape[1]
        scores = torch.einsum("bqkgd,btkd->bkgqt", qg, kc.to(torch.float32)) * scale
        if causal:
            k_pos = src * tq + torch.arange(tk, device=dev)
            live = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                live = live & (q_pos[:, None] - k_pos[None, :] < window)
            scores = torch.where(live, scores, torch.tensor(_NEG, dtype=torch.float32,
                                                            device=dev))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)  # rescale of the old accumulator
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p,
                                                    vc.to(torch.float32))
        return m_new, l, acc

    kv = torch.cat([k, v], dim=-1)  # one buffer travels: one shift a step
    for i in range(s - 1):
        nxt = ring_shift_start(kv, mesh, MODEL_AXIS)
        m, l, acc = fold(kv, m, l, acc, i)
        kv = nxt.wait()
    m, l, acc = fold(kv, m, l, acc, s - 1)
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KVH, G, Tq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, hd).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh: Mesh,
                   causal: bool = True, rope_theta: float | None = None) -> torch.Tensor:
    """Multi-head attention with the sequence sharded over ``model``: q, k,
    v (B_local, T_local, H or KVH, hd) are the rank's chunks (``local_seq``
    of the global tensors); returns the rank's (B_local, T_local, H, hd)
    output. ``rope_theta`` ropes q and k at global positions first."""
    return _ring_body(q, k, v, mesh, causal, rope_theta)


def _proj(packed, name, inp, compute_dtype, use_kernel):
    """One packed projection of the rank's tokens (B1 on its rows): the
    layer's scale folded into the input, the bias fused."""
    return _local_spmm(inp.reshape(-1, inp.shape[-1]) * packed[name + "_scale"], packed[name],
                       packed[name.replace("w", "b")], None, compute_dtype, use_kernel)


def _reject_lora_sp(packed: dict) -> None:
    if any(k.endswith("_lora") for k in packed):
        raise ValueError("LoRA adapters are not supported on the sequence-parallel path yet "
                         "— serve adapted models through the single-device API")


def attention_forward_sp(packed: dict, x: torch.Tensor, cfg, *, mesh: Mesh,
                         compute_dtype=torch.float32, use_kernel: bool = True) -> torch.Tensor:
    """Sequence-parallel ternary attention layer: x (B_local, T_local,
    d_model), the rank's chunk; the packed projections (whole on every
    rank: they are 2-bit) run on the rank's tokens, attention as the KV
    ring. Returns the rank's (B_local, T_local, d_model) output."""
    _reject_lora_sp(packed)
    bl, tl, dm = x.shape
    hd = cfg.head_dim
    q = _proj(packed, "wq", x, compute_dtype, use_kernel).reshape(bl, tl, cfg.n_heads, hd)
    k = _proj(packed, "wk", x, compute_dtype, use_kernel).reshape(bl, tl, cfg.kv_heads, hd)
    v = _proj(packed, "wv", x, compute_dtype, use_kernel).reshape(bl, tl, cfg.kv_heads, hd)
    att = _ring_body(q, k, v, mesh, cfg.causal, cfg.rope_theta if cfg.rope else None,
                     cfg.window)
    return _proj(packed, "wo", att.reshape(bl, tl, -1), compute_dtype,
                 use_kernel).reshape(bl, tl, dm)
