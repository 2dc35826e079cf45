"""Ternary causal language model with dense blocks (counterpart of
smmb_tpu/models/lm.py).

Token + learned-position embeddings, N pre-norm ternary transformer blocks
(models/transformer.py), a final RMSNorm and a packed ternary LM head, with
the serving entry points ``lm_prefill``, ``lm_decode_step``, ``lm_extend``,
``lm_prefill_chunked``, ``generate``, ``fork_cache`` and ``generate_beam``.
JAX's ``generate`` is one jitted ``lax.scan``; here it is an eager loop over
decode steps that keeps the tokens on the card (no host sync per step) and
writes each block's preallocated ``max_len`` KV cache in place.

``use_flash`` runs the prefill's attention as the flash kernel B9 and the
decode and extend cache reads as B4 (kernels/flash_attention.py,
kernels/flash_decode.py) under JAX's gates. ``kv_quant`` (``quantized``
caches) stores the KV caches as int8 codes and per-token scales: the decode
and extend steps write them through B7 and, under ``use_flash``, read them
through B8. Ragged (left-padded) batches pass ``prompt_mask`` to
``lm_prefill`` and ``generate`` over a ``ragged`` cache, whose reads take the
plain attention math; ``pos_ids`` gives each row its own learned position in
``lm_decode_step`` and ``lm_extend``.

Training: ``qat_lm_forward`` runs the STE forward on the masters
(``transformer.qat_block_forward`` per block, dense f32 products), and
``make_lm_train_step`` takes Adam steps on next-token cross-entropy, with
gradient accumulation over microbatches and the checkpointed chunked
attention (``attn_chunk``). The trained masters serve through
``pack_lm(quantize=True)``.

``n_experts`` makes every block the routed MoE block of
models/moe_block.py (Switch or Mixtral by ``top_k``; ``d_ff`` is then each
expert's width). The entry points reach the block functions through
``cfg._blk``, so every one of them serves MoE blocks as it serves dense
ones, and the QAT forward sums the blocks' load-balance losses into aux.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from smmb_tpu_torch.formats.packed import pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.models import moe_block as mb
from smmb_tpu_torch.models import transformer as tb
from smmb_tpu_torch.models.train import (
    absmean_scale,
    make_adam,
    param_leaves,
    qat_linear,
    ternarize_ste,
)
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils import rng


@dataclasses.dataclass(frozen=True)
class TernaryLMConfig:
    vocab: int
    d_model: int
    n_heads: int
    d_ff: int
    n_layers: int
    max_len: int = 1024
    alpha: float = 0.2
    non_zero: int = 2
    eps: float = 1e-6
    n_kv_heads: int | None = None
    rope: bool = False
    rope_theta: float = 10000.0
    window: int | None = None
    # n_experts switches every block's FFN to the routed ternary mixture
    # (models/moe_block.py); d_ff is then the per-expert width
    n_experts: int | None = None
    top_k: int = 1
    capacity_factor: float = 1.25

    @property
    def block(self):
        common = dict(d_model=self.d_model, n_heads=self.n_heads, d_ff=self.d_ff,
                      alpha=self.alpha, causal=True, non_zero=self.non_zero,
                      eps=self.eps, n_kv_heads=self.n_kv_heads, rope=self.rope,
                      rope_theta=self.rope_theta, window=self.window)
        if self.n_experts is not None:
            return mb.TernaryMoEBlockConfig(n_experts=self.n_experts, top_k=self.top_k,
                                            capacity_factor=self.capacity_factor,
                                            **common)
        return tb.TernaryBlockConfig(**common)

    @property
    def _blk(self) -> dict:
        """The block functions: dense (transformer.py) or MoE (moe_block.py),
        one interface, chosen by ``n_experts``."""
        if self.n_experts is not None:
            return {"init": mb.init_moe_block, "forward": mb.moe_block_forward,
                    "prefill": mb.moe_block_prefill, "extend": mb.moe_block_extend,
                    "decode": mb.moe_block_decode_step, "cache": mb.init_moe_block_cache}
        return {"init": tb.init_block, "forward": tb.block_forward,
                "prefill": tb.block_prefill, "extend": tb.block_extend,
                "decode": tb.block_decode_step,
                "cache": tb.init_block_cache}


def init_lm(gen: torch.Generator, cfg: TernaryLMConfig) -> dict:
    """Dense embeddings and norms + ternary masters for the blocks and the
    head, on ``gen``'s device."""
    bcfg = cfg.block
    scale = 1.0 / math.sqrt(cfg.d_model)
    embed = rng.rand_dense(gen, (cfg.vocab, cfg.d_model)) * scale
    pos = rng.rand_dense(gen, (cfg.max_len, cfg.d_model)) * scale
    blocks = [cfg._blk["init"](gen, bcfg) for _ in range(cfg.n_layers)]
    return {
        "embed": embed,
        "pos": pos,
        "blocks": blocks,
        "norm_f": torch.ones((cfg.d_model,), device=gen.device),
        "head": rng.rand_ternary(gen, (cfg.d_model, cfg.vocab), non_zero=cfg.non_zero),
    }


def pack_lm(params: dict, quantize: bool = False) -> dict:
    """Master weights → 2-bit packed serving weights (blocks + LM head)."""
    head = params["head"]
    head_scale = torch.ones((), dtype=torch.float32, device=head.device)
    if quantize:
        head_scale = absmean_scale(head).to(torch.float32)
        head = ternarize_ste(head)

    def pack_one(b):  # a block's kind is in its tree, as in JAX
        return (mb.pack_moe_block if "moe" in b else tb.pack_block)(b, quantize=quantize)

    return {
        "embed": params["embed"],
        "pos": params["pos"],
        "blocks": [pack_one(b) for b in params["blocks"]],
        "norm_f": params["norm_f"],
        "head": pack_ternary_device(head),
        "head_scale": head_scale,
    }


def _head_logits(packed, h, cfg, compute_dtype, use_kernel):
    b, t, d = h.shape
    h2 = h.reshape(b * t, d)
    if use_kernel:
        y = packed_spmm(h2, packed["head"], compute_dtype=compute_dtype)
    else:
        y = packed_spmm_ref(h2, packed["head"], dtype=torch.float32)
    return (y * packed["head_scale"]).reshape(b, t, cfg.vocab)


def lm_forward(packed: dict, tokens: torch.Tensor, cfg: TernaryLMConfig, *,
               compute_dtype=torch.float32, use_kernel: bool = True,
               use_flash: bool = False) -> torch.Tensor:
    """Full causal forward: (B, T) tokens → (B, T, vocab) logits."""
    b, t = tokens.shape
    x = packed["embed"][tokens] + packed["pos"][None, :t]
    for blk in packed["blocks"]:
        x = cfg._blk["forward"](blk, x, cfg.block, compute_dtype=compute_dtype,
                                use_kernel=use_kernel, use_flash=use_flash)
    h = tb.rmsnorm(x, packed["norm_f"], cfg.eps)
    return _head_logits(packed, h, cfg, compute_dtype, use_kernel)


def lm_init_cache(cfg: TernaryLMConfig, batch: int, dtype=torch.float32,
                  quantized: bool = False, ragged: bool = False,
                  device=None) -> list:
    """One preallocated (B, max_len) KV cache per block on ``device``
    (None = the CUDA card); ``quantized``: the merged int8 layout
    (``attention.init_kv_cache``)."""
    return [cfg._blk["cache"](cfg.block, batch, cfg.max_len, dtype=dtype,
                              quantized=quantized, ragged=ragged, device=device)
            for _ in range(cfg.n_layers)]


def lm_prefill(packed: dict, tokens: torch.Tensor, cache: list,
               cfg: TernaryLMConfig, *, compute_dtype=torch.float32,
               use_kernel: bool = True, use_flash: bool = False,
               prompt_mask=None):
    """Prompt pass: returns (last-position logits (B, vocab), filled cache).

    ``prompt_mask`` (B, T) bool marks the real tokens of a LEFT-padded
    ragged batch (each row's real tokens are its rightmost run, so every
    row's last token sits at T-1 and one ``pos`` serves all rows). It needs
    a ragged cache; each row's learned position is its logical one,
    ``clip(cumsum(mask) - 1, 0)`` (pads reuse position 0 and are masked out
    of attention)."""
    b, t = tokens.shape
    if prompt_mask is None:
        x = packed["embed"][tokens] + packed["pos"][None, :t]
    else:
        prompt_mask = prompt_mask.to(torch.bool)
        pos_ids = (torch.cumsum(prompt_mask.to(torch.int64), dim=1) - 1).clamp_min(0)
        x = packed["embed"][tokens] + packed["pos"][pos_ids]
    new_cache = []
    for blk, c in zip(packed["blocks"], cache):
        x, c = cfg._blk["prefill"](blk, x, c, cfg.block, compute_dtype=compute_dtype,
                                   use_kernel=use_kernel, use_flash=use_flash,
                                   valid=prompt_mask)
        new_cache.append(c)
    h = tb.rmsnorm(x, packed["norm_f"], cfg.eps)
    logits = _head_logits(packed, h, cfg, compute_dtype, use_kernel)
    return logits[:, -1], new_cache


def lm_decode_step(packed: dict, token_t: torch.Tensor, cache: list,
                   cfg: TernaryLMConfig, *, compute_dtype=torch.float32,
                   use_kernel: bool = True, pos_ids=None, use_flash: bool = False):
    """One decode step: (B,) tokens → ((B, vocab) logits, cache). The
    position comes from the first block's cache (all blocks advance in
    lockstep). ``pos_ids`` (B,) gives each row its own learned-position
    index (ragged batches and batched speculative decoding, where a row's
    logical position trails its buffer position)."""
    if pos_ids is None:
        pe = packed["pos"][cache[0]["pos"]][None, None]
    else:
        pe = packed["pos"][pos_ids][:, None]
    x = packed["embed"][token_t][:, None, :] + pe
    new_cache = []
    for blk, c in zip(packed["blocks"], cache):
        x, c = cfg._blk["decode"](blk, x, c, cfg.block, compute_dtype=compute_dtype,
                                  use_kernel=use_kernel, use_flash=use_flash)
        new_cache.append(c)
    h = tb.rmsnorm(x, packed["norm_f"], cfg.eps)
    logits = _head_logits(packed, h, cfg, compute_dtype, use_kernel)
    return logits[:, 0], new_cache


def _make_sampler(temperature: float, top_k: int | None, top_p: float | None = None):
    """Token-selection rule for ``generate``: ``sample(gen, logits)``.

    temperature == 0 → greedy argmax (the first maximum, as jnp.argmax;
    ``gen`` unused). Otherwise softmax sampling at the temperature, after
    the top-k and/or top-p (nucleus) masks, by the Gumbel-max rule that
    ``jax.random.categorical`` uses, with uniforms drawn from ``gen``. The
    random streams differ from JAX's, so only the distributions compare.
    """
    if temperature == 0.0:
        return lambda gen, logits: torch.argmax(logits, dim=-1)

    def sample(gen, logits):
        logits = logits.to(torch.float32) / temperature
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        if top_p is not None:
            srt = torch.sort(logits, dim=-1, descending=True).values
            probs = torch.softmax(srt, dim=-1)
            before = torch.cumsum(probs, dim=-1) - probs
            cut = torch.where(before < top_p, srt, float("inf")).amin(dim=-1, keepdim=True)
            logits = logits.masked_fill(logits < cut, float("-inf"))
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    return sample


def generate(packed: dict, prompt: torch.Tensor, cfg: TernaryLMConfig,
             steps: int, *, compute_dtype=torch.float32, use_kernel: bool = True,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, generator: torch.Generator | None = None,
             use_flash: bool = False, kv_quant: bool = False,
             prompt_mask=None, prefill_chunk: int | None = None) -> torch.Tensor:
    """Generation: (B, T) prompt → (B, steps) continuation tokens.

    Greedy by default; ``temperature > 0`` samples with ``generator`` (the
    port's ``torch.Generator`` in place of JAX's key). The KV caches follow
    the compute dtype and are preallocated at ``cfg.max_len`` on the
    prompt's device; each step writes them in place. As in JAX, the last
    step's logits pick no token. ``use_flash`` runs the prefill through B9
    and the decode steps' cache reads through B4 (under JAX's gate).
    ``kv_quant`` stores int8 codes and per-token absmax scales in place of
    the float caches (B7 writes them each step, B8 reads them under
    ``use_flash``). ``prefill_chunk`` runs the prompt through
    ``lm_prefill_chunked`` (T % chunk == 0); as in JAX it is not combinable
    with ``use_flash``. ``prompt_mask`` (B, T) bool serves a ragged batch:
    left-pad each prompt, mark its real tokens; each row then generates
    what it would alone. Its caches are read by the plain attention math
    (the flash prefill refuses the mask, as in JAX).
    """
    if prefill_chunk is not None and (prompt_mask is not None or use_flash):
        raise ValueError("prefill_chunk is not combinable with prompt_mask/use_flash")
    if prompt.shape[1] + steps > cfg.max_len:
        raise ValueError(f"prompt_len={prompt.shape[1]} + steps={steps} exceeds "
                         f"max_len={cfg.max_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 sampling needs a torch.Generator")
    sampler = _make_sampler(temperature, top_k, top_p)
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel)
    cache = lm_init_cache(cfg, prompt.shape[0], dtype=compute_dtype,
                          quantized=kv_quant, ragged=prompt_mask is not None,
                          device=prompt.device)
    if prefill_chunk is not None:
        logits, cache = lm_prefill_chunked(packed, prompt, cache, cfg, prefill_chunk, **kw)
    else:
        logits, cache = lm_prefill(packed, prompt, cache, cfg, use_flash=use_flash,
                                   prompt_mask=prompt_mask, **kw)
    tok = sampler(generator, logits)
    # per-row logical positions for the learned embedding (ragged only)
    row_pos = None if prompt_mask is None else prompt_mask.to(torch.int64).sum(dim=1)
    toks = []
    for _ in range(steps):
        toks.append(tok)
        logits, cache = lm_decode_step(packed, tok, cache, cfg, pos_ids=row_pos,
                                       use_flash=use_flash and row_pos is None, **kw)
        tok = sampler(generator, logits)
        if row_pos is not None:
            row_pos = row_pos + 1
    return torch.stack(toks, dim=1)


def _chunk_embed(packed, tokens, pos: int, cfg: TernaryLMConfig):
    """Token + learned-position embeddings of a (B, C) chunk at ``pos``."""
    c = tokens.shape[1]
    if pos + c > cfg.max_len:
        raise ValueError(f"chunk of {c} at position {pos} exceeds max_len={cfg.max_len}")
    return packed["embed"][tokens] + packed["pos"][None, pos:pos + c]


def lm_extend(packed: dict, tokens: torch.Tensor, cache: list,
              cfg: TernaryLMConfig, *, compute_dtype=torch.float32,
              use_kernel: bool = True, use_flash: bool = False, pos_ids=None):
    """Append a (B, C) token chunk at the cache position and return the
    logits at every chunk position: ((B, C, vocab), cache). The multi-token
    ``lm_decode_step``: each chunk token attends the cache plus its chunk
    prefix. Under ``use_flash`` the caches are read by B4's chunk entry, the
    decode step's kernel, so a token's logits equal its decode step's.
    ``pos_ids`` (B, C) overrides the learned-position indices per row
    (batched speculative decoding, where dead cache slots make a row's
    logical position trail its buffer position)."""
    if tokens.shape[1] > cfg.max_len:
        raise ValueError(f"chunk {tokens.shape[1]} exceeds max_len={cfg.max_len}")
    if pos_ids is None:
        x = _chunk_embed(packed, tokens, cache[0]["pos"], cfg)
    else:
        x = packed["embed"][tokens] + packed["pos"][pos_ids]
    new_cache = []
    for blk, ch in zip(packed["blocks"], cache):
        x, ch = cfg._blk["extend"](blk, x, ch, cfg.block, compute_dtype=compute_dtype,
                                   use_kernel=use_kernel, use_flash=use_flash)
        new_cache.append(ch)
    h = tb.rmsnorm(x, packed["norm_f"], cfg.eps)
    return _head_logits(packed, h, cfg, compute_dtype, use_kernel), new_cache


def lm_prefill_chunked(packed: dict, tokens: torch.Tensor, cache: list,
                       cfg: TernaryLMConfig, chunk: int, *,
                       compute_dtype=torch.float32, use_kernel: bool = True,
                       use_flash: bool = False):
    """Prompt pass in chunks of ``chunk`` tokens (T % chunk == 0), each
    through ``block_extend`` over the cache filled so far: ``lm_prefill``'s
    result without a (T, T) score tensor. The head runs once, on the last
    position. Returns (last-position logits (B, vocab), filled cache)."""
    b, t = tokens.shape
    if t % chunk:
        raise ValueError(f"prompt length {t} not divisible by chunk {chunk}")
    if t > cfg.max_len:
        raise ValueError(f"prompt length {t} exceeds max_len={cfg.max_len}")
    for c0 in range(0, t, chunk):
        x = _chunk_embed(packed, tokens[:, c0:c0 + chunk], cache[0]["pos"], cfg)
        new_cache = []
        for blk, ch in zip(packed["blocks"], cache):
            x, ch = cfg._blk["extend"](blk, x, ch, cfg.block, compute_dtype=compute_dtype,
                                       use_kernel=use_kernel, use_flash=use_flash)
            new_cache.append(ch)
        cache = new_cache
    h = tb.rmsnorm(x[:, -1:], packed["norm_f"], cfg.eps)
    return _head_logits(packed, h, cfg, compute_dtype, use_kernel)[:, 0], cache


def _reindex_cache(cache: list, idx: torch.Tensor) -> list:
    """Gather cache rows by beam index (copies; ``pos`` passes through)."""
    return [{k_: (v[idx] if isinstance(v, torch.Tensor) else v) for k_, v in c.items()}
            for c in cache]


def fork_cache(cache: list, n: int) -> list:
    """Prefix caching: a batch-1 prefilled cache made into ``n`` rows.

    Serve a shared prompt once (``lm_prefill`` at batch 1), fork, then run
    ``n`` divergent continuations batched. JAX broadcasts the buffers, which
    is safe there because nothing is written in place; the port's caches are
    written in place, so every row here is a copy of its own (an expanded
    view would send all the rows' writes into one row)."""
    if cache:
        code_buf = cache[0]["kv" if "kv" in cache[0] else "k"]
        if code_buf.shape[0] != 1:
            raise ValueError(f"fork_cache takes a batch-1 cache, got batch {code_buf.shape[0]}")
    return [{k_: (v.expand(n, *v.shape[1:]).clone() if isinstance(v, torch.Tensor) else v)
             for k_, v in c.items()} for c in cache]


def generate_beam(packed: dict, prompt: torch.Tensor, cfg: TernaryLMConfig,
                  steps: int, *, beam: int = 4, compute_dtype=torch.float32,
                  use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam search: (1, T) prompt → ((beam, steps) tokens, (beam,) f32 scores).

    A fixed-width beam over summed log-probabilities (f32 ``log_softmax``,
    no EOS and no length normalisation, as in JAX). The beams are rows of a
    forked float cache; each step scores beam × vocab continuations, keeps
    the top ``beam`` and gathers the cache rows by surviving beam.
    ``beam=1`` is greedy ``generate``. Hypotheses come out best first."""
    b, t = prompt.shape
    if b != 1:
        raise ValueError(f"beam search is batch-1 only (got batch {b})")
    if t + steps > cfg.max_len:
        raise ValueError(f"prompt_len={t} + steps={steps} exceeds max_len={cfg.max_len}")
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel)
    cache = lm_init_cache(cfg, 1, dtype=compute_dtype, device=prompt.device)
    logits, cache = lm_prefill(packed, prompt, cache, cfg, **kw)
    logp = torch.log_softmax(logits[0].to(torch.float32), dim=-1)
    scores, tok = torch.topk(logp, beam)
    cache = fork_cache(cache, beam)
    toks = torch.zeros((beam, steps), dtype=torch.int64, device=prompt.device)
    toks[:, 0] = tok
    for i in range(1, steps):
        logits, cache = lm_decode_step(packed, tok, cache, cfg, **kw)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)  # (beam, V)
        scores, flat = torch.topk((scores[:, None] + logp).reshape(-1), beam)
        src = flat // cfg.vocab  # the beam each survivor came from
        tok = flat % cfg.vocab
        cache = _reindex_cache(cache, src)
        toks = toks[src]
        toks[:, i] = tok
    return toks, scores


def _qat_lm_forward_aux(params: dict, tokens: torch.Tensor, cfg: TernaryLMConfig,
                       attn_chunk: int | None = None):
    """(logits, aux): the QAT forward and the MoE blocks' load-balance
    losses summed (zero for dense blocks)."""
    bcfg = cfg.block
    t = tokens.shape[1]
    x = params["embed"][tokens] + params["pos"][None, :t]
    aux = torch.zeros((), device=x.device)
    for blk in params["blocks"]:
        if cfg.n_experts is not None:
            x, a = mb.qat_moe_block_forward(blk, x, bcfg, attn_chunk=attn_chunk)
            aux = aux + a
        else:
            x = tb.qat_block_forward(blk, x, bcfg, attn_chunk=attn_chunk)
    h = tb.rmsnorm(x, params["norm_f"], cfg.eps)
    return qat_linear(h, params["head"]), aux


def qat_lm_forward(params: dict, tokens: torch.Tensor, cfg: TernaryLMConfig,
                   attn_chunk: int | None = None) -> torch.Tensor:
    """Training forward on the masters: (B, T) tokens → (B, T, vocab) f32
    logits. Blocks and head are STE-ternarized (differentiable); embeddings,
    positions and norm gains train dense. Mirrors ``lm_forward``'s serving
    math, so ``pack_lm(quantize=True)`` serves what was trained.
    ``attn_chunk``: memory-efficient attention (O(T·chunk) residuals)."""
    return _qat_lm_forward_aux(params, tokens, cfg, attn_chunk)[0]


def lm_loss(params: dict, tokens: torch.Tensor, cfg: TernaryLMConfig,
            attn_chunk: int | None = None, aux_weight: float = 1e-2) -> torch.Tensor:
    """The training loss: the mean cross-entropy of the QAT forward's
    ``logits[:, :-1]`` against ``tokens[:, 1:]``, plus ``aux_weight·aux``
    (the MoE blocks' summed load-balance loss; zero for dense blocks)."""
    logits, aux = _qat_lm_forward_aux(params, tokens, cfg, attn_chunk)
    ce = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    return ce + aux_weight * aux


def make_lm_train_step(cfg: TernaryLMConfig, learning_rate: float = 1e-3,
                       accum_steps: int = 1, attn_chunk: int | None = None,
                       aux_weight: float = 1e-2):
    """(init_opt, train_step) for next-token cross-entropy on the ternary LM.

    ``init_opt(params)`` returns the ``opt_state``, a ``torch.optim.Adam``
    (optax's defaults) over every master tensor of ``params``, which it
    marks as requiring grad. ``train_step(params, opt_state, tokens) ->
    (params, opt_state, loss)`` updates the masters in place and returns
    them with the batch's loss before the update.

    The loss is the mean cross-entropy of ``logits[:, :-1]`` against
    ``tokens[:, 1:]`` plus ``aux_weight·aux``, aux being the MoE blocks'
    summed load-balance loss (zero for dense blocks, where ``aux_weight``
    changes nothing). ``accum_steps > 1`` splits
    the batch into that many equal microbatches, one forward and backward
    each (one microbatch's activations live at a time); their gradients are
    summed, then scaled by 1/``accum_steps`` before the single Adam step:
    the full-batch step's math, the mean of equal-size means being the
    batch mean.
    """
    def loss_fn(params, tokens):
        return lm_loss(params, tokens, cfg, attn_chunk, aux_weight)

    def init_opt(params):
        return make_adam(params, learning_rate)

    def train_step(params, opt_state, tokens):
        b = tokens.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        opt_state.zero_grad(set_to_none=True)
        total = 0.0
        for mb in tokens.long().reshape(accum_steps, b // accum_steps, -1):
            loss = loss_fn(params, mb)
            loss.backward()  # sums into .grad across microbatches
            total = total + loss.detach()
        if accum_steps > 1:
            for p in param_leaves(params):
                if p.grad is not None:
                    p.grad.mul_(1.0 / accum_steps)
        opt_state.step()
        return params, opt_state, total / accum_steps

    return init_opt, train_step
