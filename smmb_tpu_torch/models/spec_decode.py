"""Greedy speculative decoding (counterpart of smmb_tpu/models/spec_decode.py).

A small ternary draft LM proposes, the target verifies k tokens a round, and
the output is token for token the target's own greedy ``generate``: the
draft changes when tokens are computed, never what. Each round:

1. the draft runs k+1 decode steps from the last accepted token (k
   proposals and one step that consumes the k-th, so that its cache stays
   in step with the target's on full acceptance);
2. the target verifies ``[t_last, d_1..d_k]`` with one ``lm_extend`` call;
3. the longest prefix of proposals that matches the target's argmax is
   accepted, plus the target's own next token (n_acc + 1 ≥ 1 tokens);
4. both caches rewind ``pos`` to the accepted length (the slots past it are
   masked by position and overwritten later).

JAX runs the rounds in a ``lax.while_loop``; here they are an eager loop
with one host read a round (the accepted count, which moves the Python-int
cache positions). Under ``use_flash`` the draft steps read their caches
through B4's decode entry and the verify chunk through its chunk entry,
whose rows equal the decode rows bitwise, and the prefills run B9.

Batch > 1 keeps every cache write aligned across rows: each round appends
the full (k+1)-token chunk at the shared position, and a ragged cache's
``valid`` mask marks each row's rejected tail dead; a row's logical
position, for the learned embedding, trails its buffer position and goes in
as ``pos_ids``. Ragged caches are read by the plain attention math. Rope is
refused there (dead slots would distort buffer-position rope offsets).

``make_draft_distill_step`` trains a draft's masters to imitate the packed
target, the step that makes speculative decoding pay.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.models.lm import (
    TernaryLMConfig,
    lm_decode_step,
    lm_extend,
    lm_forward,
    lm_init_cache,
    lm_prefill,
    qat_lm_forward,
)
from smmb_tpu_torch.models.train import make_adam


def _set_pos(cache: list, pos: int) -> list:
    """Rewind every block cache to ``pos`` consumed tokens."""
    return [{**c, "pos": pos} for c in cache]


def make_draft_distill_step(target: dict, target_cfg: TernaryLMConfig,
                            draft_cfg: TernaryLMConfig, learning_rate: float = 1e-3,
                            temperature: float = 2.0):
    """(init_opt, distill_step) training a draft's MASTERS to imitate the
    packed target: a random draft is accepted ~1/vocab of the time, a
    distilled one tracks the target's argmax where it matters.

    ``distill_step(draft_params, opt_state, tokens) -> (params, opt_state,
    loss)``: soft cross-entropy at ``temperature`` between the frozen
    target's logits and the draft's ``qat_lm_forward``, one Adam step
    (``opt_state`` is the ``torch.optim.Adam`` of ``init_opt``, as in
    ``make_lm_train_step``); the trained masters pack into the 2-bit draft
    through ``pack_lm(quantize=True)``. The target's logits come from
    ``lm_forward`` (f32) under ``torch.no_grad()``: on the card through its
    kernels, on CPU tensors through their plain versions, the same function
    (JAX takes the jnp path under ``stop_gradient``). Vocabularies must
    match.
    """
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError(f"vocab mismatch: target {target_cfg.vocab} vs draft {draft_cfg.vocab}")
    inv_t = 1.0 / temperature

    def init_opt(params):
        return make_adam(params, learning_rate)

    def distill_step(params, opt_state, tokens):
        with torch.no_grad():
            t_logits = lm_forward(target, tokens, target_cfg)
        opt_state.zero_grad(set_to_none=True)
        d_logits = qat_lm_forward(params, tokens, draft_cfg)
        p = torch.softmax(t_logits * inv_t, dim=-1)
        logq = torch.log_softmax(d_logits * inv_t, dim=-1)
        loss = -torch.mean(torch.sum(p * logq, dim=-1))
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_opt, distill_step


def _prefill_both(target, draft, prompt, target_cfg, draft_cfg, kw, ragged=False):
    """Fresh caches, both prompts prefilled; the target's first token."""
    b = prompt.shape[0]
    dt = kw["compute_dtype"]
    tc = lm_init_cache(target_cfg, b, dtype=dt, ragged=ragged, device=prompt.device)
    dc = lm_init_cache(draft_cfg, b, dtype=dt, ragged=ragged, device=prompt.device)
    logits, tc = lm_prefill(target, prompt, tc, target_cfg, **kw)
    _, dc = lm_prefill(draft, prompt, dc, draft_cfg, **kw)
    return torch.argmax(logits, dim=-1), tc, dc


def _propose(draft, t_last, dc, draft_cfg, k, kw, pos_ids=None):
    """k+1 draft decode steps from ``t_last``: ((B, k) proposals, cache)."""
    tok, drafts = t_last, []
    for j in range(k + 1):
        lg, dc = lm_decode_step(draft, tok, dc, draft_cfg,
                                pos_ids=None if pos_ids is None else pos_ids + j, **kw)
        tok = torch.argmax(lg, dim=-1)
        drafts.append(tok)
    return torch.stack(drafts[:k], dim=1), dc


def _accept(preds, drafts):
    """Per row: the accepted count (B,) and the (B, k+1) slab of emitted
    tokens (the accepted drafts, then the target's next token)."""
    b, k = drafts.shape
    n_acc = torch.cumprod((preds[:, :k] == drafts).to(torch.int64), dim=1).sum(dim=1)
    nxt = torch.gather(preds, 1, n_acc[:, None])[:, 0]
    idx = torch.arange(k + 1, device=preds.device)[None]
    ext = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    return n_acc, nxt, torch.where(idx < n_acc[:, None], ext, nxt[:, None])


def generate_speculative(target: dict, draft: dict, prompt: torch.Tensor,
                         target_cfg: TernaryLMConfig, draft_cfg: TernaryLMConfig,
                         steps: int, *, k: int = 4, compute_dtype=torch.float32,
                         use_kernel: bool = True, use_flash: bool = False,
                         return_stats: bool = False):
    """(B, T) prompt → (B, steps) greedy continuation of the TARGET model,
    computed in draft-proposed, target-verified rounds of k proposals.

    ``target`` and ``draft`` are packed LMs (``pack_lm``) with one
    vocabulary, on the prompt's device. The output equals
    ``generate(target, prompt, target_cfg, steps)`` token for token; under
    ``use_flash`` on the card that rests on B1/B3/B5 rows being independent
    of M and on B4's chunk rows equalling its decode rows. ``return_stats``
    adds ``{"rounds", "mean_accepted"}`` (accepted proposals a round).
    """
    b, t = prompt.shape
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel, use_flash=use_flash)
    if b > 1:
        return _generate_speculative_batched(target, draft, prompt, target_cfg, draft_cfg,
                                             steps, k=k, kw=kw, return_stats=return_stats)
    room = min(target_cfg.max_len, draft_cfg.max_len)
    if t + steps + k + 1 > room:
        raise ValueError(f"prompt {t} + steps {steps} + k+1 {k + 1} exceeds max_len {room}")
    tok0, tc, dc = _prefill_both(target, draft, prompt, target_cfg, draft_cfg, kw)
    out = torch.zeros((1, steps + k + 1), dtype=torch.int64, device=prompt.device)
    out[:, 0] = tok0
    count, t_last, rounds = 1, tok0, 0
    while count < steps:
        p_t, p_d = tc[0]["pos"], dc[0]["pos"]
        drafts, dc = _propose(draft, t_last, dc, draft_cfg, k, kw)
        vlogits, tc = lm_extend(target, torch.cat([t_last[:, None], drafts], dim=1), tc,
                                target_cfg, **kw)
        n_acc, nxt, slab = _accept(torch.argmax(vlogits, dim=-1), drafts)
        out[:, count:count + k + 1] = slab
        consumed = int(n_acc[0]) + 1  # the round's one host read
        tc, dc = _set_pos(tc, p_t + consumed), _set_pos(dc, p_d + consumed)
        count, t_last, rounds = count + consumed, nxt, rounds + 1
    if return_stats:
        # emitted a round = n_acc + 1, so the mean accepted proposals a
        # round is (tokens emitted by rounds) / rounds − 1
        return out[:, :steps], {"rounds": rounds,
                                "mean_accepted": (count - 1) / max(rounds, 1) - 1.0}
    return out[:, :steps]


def _clear_dead(cache: list, base: int, keep: torch.Tensor, k: int) -> list:
    """Mark each row's accepted prefix of the round's (k+1)-token chunk
    valid and its rejected tail dead, in place: valid[:, base+j] = j < keep."""
    mask = torch.arange(k + 1, device=keep.device)[None] < keep[:, None]
    for c in cache:
        c["valid"][:, base:base + k + 1] = mask
    return cache


def _generate_speculative_batched(target, draft, prompt, target_cfg, draft_cfg, steps,
                                  *, k: int, kw: dict, return_stats: bool):
    """Batched greedy speculative decoding by aligned writes and dead-slot
    ``valid`` masks (module docstring). Each row equals the target's own
    greedy continuation of that row under the same attention path (the
    ragged caches are read by the plain attention math)."""
    b, t = prompt.shape
    if target_cfg.rope or draft_cfg.rope:
        raise ValueError("batched speculative decoding requires rope=False: dead "
                         "interior cache slots distort buffer-position rope offsets")
    # at worst every round accepts one token: steps-1 rounds of k+1 slots
    need = t + (steps - 1) * (k + 1) + 1
    room = min(target_cfg.max_len, draft_cfg.max_len)
    if need > room:
        raise ValueError(f"batched spec decode can consume up to prompt {t} + "
                         f"(steps-1)·(k+1) = {need} buffer slots; max_len {room} is too small")
    dev = prompt.device
    tok0, tc, dc = _prefill_both(target, draft, prompt, target_cfg, draft_cfg, kw, ragged=True)
    w = steps + k + 1
    out = torch.zeros((b, w), dtype=torch.int64, device=dev)
    out[:, 0] = tok0
    cols = torch.arange(w, device=dev)[None]
    chunk_pos = torch.arange(k + 1, device=dev)[None]
    count = torch.ones(b, dtype=torch.int64, device=dev)
    llen = torch.full((b,), t, dtype=torch.int64, device=dev)
    t_last, rounds = tok0, 0
    while int(count.min()) < steps:  # the round's one host read
        p_t, p_d = tc[0]["pos"], dc[0]["pos"]
        drafts, dc = _propose(draft, t_last, dc, draft_cfg, k, kw, pos_ids=llen)
        vlogits, tc = lm_extend(target, torch.cat([t_last[:, None], drafts], dim=1), tc,
                                target_cfg, pos_ids=llen[:, None] + chunk_pos, **kw)
        n_acc, nxt, slab = _accept(torch.argmax(vlogits, dim=-1), drafts)
        # each row's slab lands at its own count
        rel = cols - count[:, None]
        in_slab = (rel >= 0) & (rel < k + 1)
        out = torch.where(in_slab, torch.gather(slab, 1, rel.clamp(0, k)), out)
        consumed = n_acc + 1
        _clear_dead(tc, p_t, consumed, k)
        _clear_dead(dc, p_d, consumed, k)
        count, t_last, llen, rounds = count + consumed, nxt, llen + consumed, rounds + 1
    if return_stats:
        mean = float(((count - 1).to(torch.float64) / max(rounds, 1) - 1.0).mean())
        return out[:, :steps], {"rounds": rounds, "mean_accepted": mean}
    return out[:, :steps]
