#!/usr/bin/env python
"""Tour of the PyTorch port's serving stack on one tiny ternary LM (the
counterpart of examples/serving_features.py): chunked prefill, speculative
decoding, beam search, sampling controls, int8 KV cache, prefix caching,
ragged batches, rope/window/GQA configs and LoRA adapters.

On the card by default (f32 compute, as JAX's example); ``--cpu`` runs the
plain versions on CPU tensors:

    python examples/torch_serving_features.py [--cpu]

``main`` returns 0 when every claim the tour prints holds: speculative
decoding token for token greedy, the chunked prefill within 1e-3 of the
one-shot prefill (JAX's ``atol``), row 0 of the ragged batch equal to its
solo run, and the LoRA loss falling over its 3 steps.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from smmb_tpu_torch.models.lm import (  # noqa: E402
    TernaryLMConfig,
    fork_cache,
    generate,
    generate_beam,
    init_lm,
    lm_decode_step,
    lm_init_cache,
    lm_prefill,
    lm_prefill_chunked,
    pack_lm,
)
from smmb_tpu_torch.models.lora import (  # noqa: E402
    attach_lora,
    init_lora_lm,
    make_lora_train_step,
)
from smmb_tpu_torch.models.spec_decode import generate_speculative  # noqa: E402
from smmb_tpu_torch.utils import rng  # noqa: E402
from smmb_tpu_torch.utils.device import resolve_device  # noqa: E402


def _tokens(seed, shape, vocab, dev):
    return torch.randint(0, vocab, shape, generator=rng.make_generator(seed, dev), device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="plain versions on CPU tensors")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    claims = {}

    # rope + GQA + sliding window, all through one config
    cfg = TernaryLMConfig(vocab=256, d_model=256, n_heads=4, d_ff=512, n_layers=2,
                          max_len=128, n_kv_heads=2, rope=True, window=32)
    packed = pack_lm(init_lm(rng.make_generator(0, dev), cfg))
    prompt = _tokens(1, (1, 16), cfg.vocab, dev)

    greedy = generate(packed, prompt, cfg, 12)
    print("greedy      :", greedy[0].tolist())
    print("sampled     :", generate(packed, prompt, cfg, 12, temperature=0.8, top_k=40,
                                    top_p=0.95, generator=rng.make_generator(2, dev))[0].tolist())
    print("int8 cache  :", generate(packed, prompt, cfg, 12, kv_quant=True)[0].tolist())
    beams, scores = generate_beam(packed, prompt, cfg, 12, beam=4)
    print("beam best   :", beams[0].tolist(), f"(score {float(scores[0]):.2f})")

    # speculative decoding: 1-layer draft proposes, target verifies
    dcfg = TernaryLMConfig(vocab=256, d_model=128, n_heads=2, d_ff=256, n_layers=1,
                           max_len=128, rope=True, window=32, n_kv_heads=2)
    draft = pack_lm(init_lm(rng.make_generator(3, dev), dcfg))
    spec = generate_speculative(packed, draft, prompt, cfg, dcfg, 12, k=4)
    claims["speculative == greedy"] = torch.equal(spec, greedy)
    print("speculative :", spec[0].tolist(),
          f"(token-identical to greedy: {claims['speculative == greedy']})")

    # chunked prefill: long prompt in 16-token segments, same cache state
    long_prompt = _tokens(4, (1, 64), cfg.vocab, dev)
    l1, _ = lm_prefill(packed, long_prompt, lm_init_cache(cfg, 1, device=dev), cfg)
    l2, _ = lm_prefill_chunked(packed, long_prompt, lm_init_cache(cfg, 1, device=dev), cfg,
                               chunk=16)
    claims["chunked prefill"] = torch.allclose(l1, l2, rtol=0.0, atol=1e-3)
    print(f"chunked prefill matches one-shot: {claims['chunked prefill']} "
          f"(max diff {float((l1 - l2).abs().max()):.2e})")

    # prefix caching: prefill once, fork for 3 divergent continuations
    _, shared = lm_prefill(packed, prompt, lm_init_cache(cfg, 1, device=dev), cfg)
    forked = fork_cache(shared, 3)
    div = torch.tensor([7, 99, 200], device=dev)
    logits, _ = lm_decode_step(packed, div, forked, cfg)
    print("prefix-cache fork: 3 continuations from one prefill,",
          "next tokens", torch.argmax(logits, dim=-1).tolist())

    # ragged batch: 5- and 13-token prompts served together, left-padded
    pa = _tokens(5, (1, 5), cfg.vocab, dev)
    pb = _tokens(6, (1, 13), cfg.vocab, dev)
    batch = torch.cat([F.pad(pa, (8, 0)), pb])
    mask = torch.cat([F.pad(torch.ones((1, 5), dtype=torch.bool, device=dev), (8, 0)),
                      torch.ones((1, 13), dtype=torch.bool, device=dev)])
    ragged = generate(packed, batch, cfg, 8, prompt_mask=mask)
    solo = generate(packed, pa, cfg, 8)
    claims["ragged row 0 == solo"] = torch.equal(ragged[0], solo[0])
    print("ragged row 0 == its solo run:", claims["ragged row 0 == solo"])

    # LoRA: fine-tune adapters on the frozen 2-bit base (3 steps for show)
    adapters = init_lora_lm(rng.make_generator(7, dev), cfg, rank=4)
    init_opt, lstep = make_lora_train_step(packed, cfg, learning_rate=5e-3)
    opt = init_opt(adapters)
    ltoks = _tokens(8, (4, 24), cfg.vocab, dev)
    losses = []
    for _ in range(3):
        adapters, opt, loss = lstep(adapters, opt, ltoks)
        losses.append(float(loss))
    claims["LoRA loss falls"] = losses[-1] < losses[0]
    print(f"LoRA adapters: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          "2-bit base untouched; serve via attach_lora(packed, adapters)")
    with torch.no_grad():
        adapted = attach_lora(packed, [{k: (a.detach(), b.detach()) for k, (a, b) in blk.items()}
                                       for blk in adapters])
        print("adapted greedy:", generate(adapted, prompt, cfg, 8)[0].tolist())

    failed = [name for name, ok in claims.items() if not ok]
    print("claims:", "all hold" if not failed else f"FAILED {failed}")
    return 0 if not failed else 1


if __name__ == "__main__":
    raise SystemExit(main())
