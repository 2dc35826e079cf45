"""Pipeline-parallel ternary LM forward over the process mesh (counterpart
of smmb_tpu/parallel/pp_lm.py).

GPipe schedule: the LM's blocks are split into S contiguous stages over the
``model`` axis, one stage a rank; a batch is cut into U microbatches that
flow through the pipe in U + S − 1 ticks, activations handed from stage to
stage by a ring send/recv (JAX's ``ppermute``). At tick i stage k runs its
blocks on microbatch i − k; JAX runs every stage at every tick inside one
static program (bubble ticks on zeros), the port's ranks skip the ticks on
which they hold no microbatch. The last stage collects the outputs, and a
model-axis ``all_reduce`` of its outputs with the other stages' zeros
replicates them, as JAX's ``psum`` does. Embedding and head run replicated
outside the pipe. Each stage runs the single-rank config's block function
on each of its layers (``cfg._blk``): dense blocks are the port's
``block_forward`` (B1, the fused kernels under their gates, B9 under
``use_flash``), MoE blocks ``moe_block_forward`` (B1 for the projections
and each expert's slab). MoE block trees stack like dense ones: the expert
planes become (L, E, K/4, N) words and the router gains a layer axis.

Constraints: ``n_layers % S == 0`` (equal stages), all blocks identically
shaped, the rank's batch divisible by U.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.formats.packed import TernaryPacked
from smmb_tpu_torch.models import lm as lm_mod
from smmb_tpu_torch.models.transformer import rmsnorm
from smmb_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_reduce, ring_shift


def _stage_count(mesh: Mesh) -> int:
    return mesh.axis_size(MODEL_AXIS)


def stack_blocks(blocks: list):
    """Stack L identically shaped packed block trees along a new leading
    axis: every tensor becomes (L, ...), every ``TernaryPacked`` holds
    (L, K_pad/4, N) words, or (L, E, K_pad/4, N) for an MoE block's expert
    stack (its meta must agree across layers)."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_blocks([b[k] for b in blocks]) for k in first}
    if isinstance(first, TernaryPacked):
        meta = {(b.rows, b.cols) for b in blocks}
        if len(meta) != 1:
            raise ValueError(f"blocks differ in packed shape: {sorted(meta)}")
        return TernaryPacked(data=torch.stack([b.data for b in blocks]),
                             rows=first.rows, cols=first.cols, nnz=-1)
    return torch.stack(list(blocks))


def _layer(stacked, i: int):
    """Layer ``i`` of a ``stack_blocks`` tree (views, contiguous)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    if isinstance(stacked, TernaryPacked):
        return TernaryPacked(data=stacked.data[i], rows=stacked.rows, cols=stacked.cols,
                             nnz=-1)
    return stacked[i]


def shard_lm_pp(packed: dict, mesh: Mesh) -> dict:
    """The rank's stage of a packed LM (models/lm.pack_lm): its n_layers / S
    contiguous blocks, stacked, on the mesh's device; embeddings, final norm
    and head whole (they run outside the pipe)."""
    s = _stage_count(mesh)
    n_layers = len(packed["blocks"])
    if n_layers % s:
        raise ValueError(f"n_layers={n_layers} % stages={s} != 0")
    per = n_layers // s
    k = mesh.index(MODEL_AXIS)
    dev = mesh.device

    def to_dev(t):  # tensors and TernaryPacked planes both have .to
        return {n: to_dev(v) for n, v in t.items()} if isinstance(t, dict) else t.to(dev)

    stage = [to_dev(b) for b in packed["blocks"][k * per:(k + 1) * per]]
    return {
        "embed": packed["embed"].to(dev),
        "pos": packed["pos"].to(dev),
        "blocks_stacked": stack_blocks(stage),
        "n_stage_layers": per,
        "norm_f": packed["norm_f"].to(dev),
        "head": packed["head"].to(dev),
        "head_scale": packed["head_scale"].to(dev),
    }


def lm_forward_pp(packed: dict, tokens: torch.Tensor, cfg, *, mesh: Mesh,
                  microbatches: int = 4, compute_dtype=torch.float32,
                  use_kernel: bool = True, use_flash: bool = False) -> torch.Tensor:
    """Pipeline-parallel LM forward: the rank's (B_local, T) tokens →
    (B_local, T, vocab) logits, on every stage."""
    s = _stage_count(mesh)
    u = microbatches
    b, t = tokens.shape
    if b % u:
        raise ValueError(f"batch={b} % microbatches={u} != 0")
    stage = mesh.index(MODEL_AXIS)
    x = packed["embed"][tokens] + packed["pos"][None, :t]
    xs = x.reshape(u, b // u, t, cfg.d_model)
    blocks = [_layer(packed["blocks_stacked"], i) for i in range(packed["n_stage_layers"])]

    def run_stage(h):
        for blk in blocks:
            h = cfg._blk["forward"](blk, h, cfg.block, compute_dtype=compute_dtype,
                                    use_kernel=use_kernel, use_flash=use_flash)
        return h

    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for i in range(u + s - 1):
        j = i - stage  # the microbatch this stage holds at tick i
        if 0 <= j < u:
            h = run_stage(xs[j] if stage == 0 else buf)
            if stage == s - 1:
                outs[j] = h
        else:
            h = buf
        if i < u + s - 2:  # hand the activations to the next stage
            buf = ring_shift(h, mesh, MODEL_AXIS)
    ys = all_reduce(outs if stage == s - 1 else torch.zeros_like(outs), mesh, MODEL_AXIS)
    h = rmsnorm(ys.reshape(b, t, cfg.d_model), packed["norm_f"], cfg.eps)
    return lm_mod._head_logits(packed, h, cfg, compute_dtype, use_kernel)
