"""Ternary causal language model — the serving part, dense blocks
(counterpart of smmb_tpu/models/lm.py).

Token + learned-position embeddings, N pre-norm ternary transformer blocks
(models/transformer.py), a final RMSNorm and a packed ternary LM head, with
the serving entry points ``lm_prefill``, ``lm_decode_step`` and
``generate``. JAX's ``generate`` is one jitted ``lax.scan``; here it is an
eager loop over decode steps that keeps the tokens on the card (no host
sync per step) and writes each block's preallocated ``max_len`` KV cache in
place.

Left out of this slice, each with a ``NotImplementedError``: MoE blocks
(``n_experts``), ``use_flash`` (kernels B4, B9), ``kv_quant`` (B7, B8),
``prompt_mask``, ``prefill_chunk``, ``lm_extend``, ``fork_cache``,
``generate_beam`` and training (``qat_lm_forward``, ``make_lm_train_step``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from smmb_tpu_torch.formats.packed import pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.models import transformer as tb
from smmb_tpu_torch.models.attention import FLASH_SLICE, INT8_CACHE_SLICE, RAGGED_SLICE
from smmb_tpu_torch.models.train import absmean_scale, ternarize_ste
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils import rng

MOE_SLICE = "MoE blocks (n_experts) belong to the training-surface slice of the port"
CONTROLS_SLICE = "{} belongs to the serving-controls slice of the port"
TRAINING_SLICE = "{} belongs to the training-surface slice of the port"


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
    n_experts: int | None = None  # MoE blocks: not in this slice

    @property
    def block(self) -> tb.TernaryBlockConfig:
        if self.n_experts is not None:
            raise NotImplementedError(MOE_SLICE)
        return tb.TernaryBlockConfig(
            d_model=self.d_model, n_heads=self.n_heads, d_ff=self.d_ff,
            alpha=self.alpha, causal=True, non_zero=self.non_zero, eps=self.eps,
            n_kv_heads=self.n_kv_heads, rope=self.rope,
            rope_theta=self.rope_theta, window=self.window,
        )


def init_lm(gen: torch.Generator, cfg: TernaryLMConfig) -> dict:
    """Dense embeddings and norms + ternary masters for the blocks and the
    head, on ``gen``'s device."""
    bcfg = cfg.block
    scale = 1.0 / math.sqrt(cfg.d_model)
    embed = rng.rand_dense(gen, (cfg.vocab, cfg.d_model)) * scale
    pos = rng.rand_dense(gen, (cfg.max_len, cfg.d_model)) * scale
    blocks = [tb.init_block(gen, bcfg) for _ in range(cfg.n_layers)]
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
    for b in params["blocks"]:
        if "moe" in b:
            raise NotImplementedError(MOE_SLICE)
    return {
        "embed": params["embed"],
        "pos": params["pos"],
        "blocks": [tb.pack_block(b, quantize=quantize) for b in params["blocks"]],
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
        x = tb.block_forward(blk, x, cfg.block, compute_dtype=compute_dtype,
                             use_kernel=use_kernel, use_flash=use_flash)
    h = tb.rmsnorm(x, packed["norm_f"], cfg.eps)
    return _head_logits(packed, h, cfg, compute_dtype, use_kernel)


def lm_init_cache(cfg: TernaryLMConfig, batch: int, dtype=torch.float32,
                  quantized: bool = False, ragged: bool = False,
                  device=None) -> list:
    """One preallocated (B, max_len) KV cache per block on ``device``
    (None = the CUDA card)."""
    return [tb.init_block_cache(cfg.block, batch, cfg.max_len, dtype=dtype,
                                quantized=quantized, ragged=ragged, device=device)
            for _ in range(cfg.n_layers)]


def lm_prefill(packed: dict, tokens: torch.Tensor, cache: list,
               cfg: TernaryLMConfig, *, compute_dtype=torch.float32,
               use_kernel: bool = True, use_flash: bool = False,
               prompt_mask=None):
    """Prompt pass: returns (last-position logits (B, vocab), filled cache)."""
    if prompt_mask is not None:
        raise NotImplementedError(RAGGED_SLICE)
    b, t = tokens.shape
    x = packed["embed"][tokens] + packed["pos"][None, :t]
    new_cache = []
    for blk, c in zip(packed["blocks"], cache):
        x, c = tb.block_prefill(blk, x, c, cfg.block, compute_dtype=compute_dtype,
                                use_kernel=use_kernel, use_flash=use_flash)
        new_cache.append(c)
    h = tb.rmsnorm(x, packed["norm_f"], cfg.eps)
    logits = _head_logits(packed, h, cfg, compute_dtype, use_kernel)
    return logits[:, -1], new_cache


def lm_decode_step(packed: dict, token_t: torch.Tensor, cache: list,
                   cfg: TernaryLMConfig, *, compute_dtype=torch.float32,
                   use_kernel: bool = True, pos_ids=None, use_flash: bool = False):
    """One decode step: (B,) tokens → ((B, vocab) logits, cache). The
    position comes from the first block's cache (all blocks advance in
    lockstep). Per-row positions (``pos_ids``) serve ragged batches and
    batched speculative decoding, which later slices bring."""
    if pos_ids is not None:
        raise NotImplementedError(RAGGED_SLICE)
    x = packed["embed"][token_t][:, None, :] + packed["pos"][cache[0]["pos"]][None, None]
    new_cache = []
    for blk, c in zip(packed["blocks"], cache):
        x, c = tb.block_decode_step(blk, x, c, cfg.block, compute_dtype=compute_dtype,
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
    step's logits pick no token.
    """
    if use_flash:
        raise NotImplementedError(FLASH_SLICE)
    if kv_quant:
        raise NotImplementedError(INT8_CACHE_SLICE)
    if prompt_mask is not None:
        raise NotImplementedError(RAGGED_SLICE)
    if prefill_chunk is not None:
        raise NotImplementedError(CONTROLS_SLICE.format("prefill_chunk"))
    if prompt.shape[1] + steps > cfg.max_len:
        raise ValueError(f"prompt_len={prompt.shape[1]} + steps={steps} exceeds "
                         f"max_len={cfg.max_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 sampling needs a torch.Generator")
    sampler = _make_sampler(temperature, top_k, top_p)
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel)
    cache = lm_init_cache(cfg, prompt.shape[0], dtype=compute_dtype,
                          device=prompt.device)
    logits, cache = lm_prefill(packed, prompt, cache, cfg, **kw)
    tok = sampler(generator, logits)
    toks = []
    for _ in range(steps):
        toks.append(tok)
        logits, cache = lm_decode_step(packed, tok, cache, cfg, **kw)
        tok = sampler(generator, logits)
    return torch.stack(toks, dim=1)


def lm_extend(*args, **kwargs):
    raise NotImplementedError(CONTROLS_SLICE.format("lm_extend"))


def fork_cache(*args, **kwargs):
    raise NotImplementedError(CONTROLS_SLICE.format("fork_cache"))


def generate_beam(*args, **kwargs):
    raise NotImplementedError(CONTROLS_SLICE.format("generate_beam"))


def qat_lm_forward(*args, **kwargs):
    raise NotImplementedError(TRAINING_SLICE.format("qat_lm_forward"))


def make_lm_train_step(*args, **kwargs):
    raise NotImplementedError(TRAINING_SLICE.format("make_lm_train_step"))
