"""Expert-parallel ternary MoE over the process mesh (counterpart of
smmb_tpu/parallel/ep_moe.py).

Experts (models/moe.py) shard over the ``model`` axis on their stacked
leading dimension: each rank owns E/model whole experts, 2-bit packed.
Tokens stay batch-sharded over ``data``; every rank routes its own tokens
against the replicated router (the port's ``router_logits``: f64 sums, one
rounding, so every rank of a model line routes a token alike), computes
slabs only for the experts it owns, and one model-axis ``all_reduce`` of
the combined partials assembles the output. Routing is recomputed rank-
locally, never exchanged.

The rank's partial is the single-rank combine (``moe._combine``) restricted
to its experts: an assignment whose expert lives elsewhere adds an exact
zero, in the same rank order. With top-k ≤ 2 a token has at most two
non-zero terms across the ranks, so the sum over the model line is the
single-rank ``moe_forward``'s f32 sum bit for bit whenever the rank holds
the same tokens (data = 1). B1 runs on the local experts' slabs only: 2·E/model
launches a call, against 2·E on one rank.
"""

from __future__ import annotations

import dataclasses

import torch

from smmb_tpu_torch.formats.packed import TernaryPacked
from smmb_tpu_torch.models.moe import (
    TernaryMoEConfig,
    _assign,
    _combine,
    _dispatch,
    _expert_ffn,
    expert_plane,
    router_logits,
)
from smmb_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_reduce

_EXPERT_KEYS = ("w_up", "s_up", "b_up", "w_down", "s_down", "b_down")


def _model_size(mesh: Mesh) -> int:
    return mesh.axis_size(MODEL_AXIS)


def ep_ffn_body(x_l: torch.Tensor, moe: dict, cfg: TernaryMoEConfig, mesh: Mesh, cap: int,
                compute_dtype, use_kernel: bool) -> torch.Tensor:
    """The rank's expert-parallel MoE application: route all of ``x_l``'s
    tokens against the replicated router at capacity ``cap``, compute the
    slabs of the rank's experts (``moe`` holds ``shard_moe_ep``'s slices),
    and sum the combined partials over the model axis. Shared by the EP
    layer and the TP-EP MoE block (parallel/tp_moe.py)."""
    e_loc = moe["b_up"].shape[0]
    off = mesh.index(MODEL_AXIS) * e_loc
    expert, slot, keep, weight = _assign(router_logits(x_l, moe["router"]), cap, cfg.top_k)
    local = keep & (expert >= off) & (expert < off + e_loc)
    # other ranks' experts are dropped here; the clamp keeps their (unused)
    # gather indices in range
    idx = (expert - off).clamp(0, e_loc - 1)
    x_e = _dispatch(x_l, idx, slot, local, e_loc, cap)
    y_e = torch.stack([
        _expert_ffn(x_e[i], expert_plane(moe["w_up"], i), moe["s_up"][i], moe["b_up"][i],
                    expert_plane(moe["w_down"], i), moe["s_down"][i], moe["b_down"][i],
                    cfg.alpha, compute_dtype, use_kernel)
        for i in range(e_loc)])
    part = _combine(y_e.to(x_l.dtype), idx, slot, local, weight)
    return all_reduce(part, mesh, MODEL_AXIS)


def shard_moe_ep(packed: dict, mesh: Mesh) -> dict:
    """The rank's expert-parallel shard of a packed MoE (models/moe.pack_moe):
    the contiguous slice ``[off:off+E/model]`` of every expert-stacked leaf,
    ``off`` = the rank's model index times E/model; the router whole. All on
    the mesh's device."""
    ms = _model_size(mesh)
    e = packed["b_up"].shape[0]
    if e % ms:
        raise ValueError(f"n_experts={e} % model={ms} != 0")
    e_loc = e // ms
    off = mesh.index(MODEL_AXIS) * e_loc
    dev = mesh.device
    out = {"router": packed["router"].to(dev)}
    for k in _EXPERT_KEYS:
        v = packed[k]
        if isinstance(v, TernaryPacked):
            out[k] = dataclasses.replace(
                v, data=v.data[off:off + e_loc].to(dev).contiguous())
        else:
            out[k] = v[off:off + e_loc].to(dev).contiguous()
    return out


def moe_forward_ep(packed: dict, x: torch.Tensor, cfg: TernaryMoEConfig, *, mesh: Mesh,
                   compute_dtype=torch.float32, use_kernel: bool = True) -> torch.Tensor:
    """Expert-parallel routed forward on ``shard_moe_ep``'s shard: x
    (N_local, d_model), the rank's batch rows → (N_local, d_model) f32.
    The capacity follows the rank's own token count, as the single-rank
    layer applied to each data shard. One model-axis all_reduce."""
    ms = _model_size(mesh)
    if cfg.n_experts % ms:
        raise ValueError(f"n_experts={cfg.n_experts} % model={ms} != 0")
    return ep_ffn_body(x, packed, cfg, mesh, cfg.capacity(x.shape[0]), compute_dtype,
                       use_kernel)
