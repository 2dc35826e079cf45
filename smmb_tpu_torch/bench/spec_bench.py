"""Speculative-decoding benchmark on the CUDA card (counterpart of
smmb_tpu/bench/spec_bench.py).

Reports µs/token for three serving configurations of the same target, each
the slope between ``steps`` and ``3·steps`` tokens timed between CUDA events
as bench/lm_bench.py times ``generate`` (the loops are eager, so host gaps
count in the time):

* plain      — ``models/lm.generate``, the autoregressive baseline;
* spec-self  — draft == target: a diagnostic of the machinery's cost. A
  same-size draft cannot pay, and acceptance is not full where the draft's
  single-row steps and the verify's (k+1)-row chunk round differently
  (bf16, near-tied random logits);
* spec-draft — an independently made small draft: on random models
  acceptance is about 1/vocab, so this bounds the cost of full rejection.

Each spec row also prints its rounds and mean accepted proposals, from one
untimed run at ``steps``. Greedy, bf16 compute and caches, the plain
attention math (no flash), as in JAX.

CLI: python -m smmb_tpu_torch spec [--layers 4] [--d-model 1024] [--n-heads 8]
     [--d-ff 4096] [--vocab 8192] [--draft-layers 1] [--draft-d-model 256]
     [--draft-d-ff 1024] [--prompt-len 32] [--steps 64] [--k 4] [--reps 3]
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.bench.measure import measure
from smmb_tpu_torch.models.lm import TernaryLMConfig, generate, init_lm, pack_lm
from smmb_tpu_torch.models.spec_decode import generate_speculative
from smmb_tpu_torch.utils import rng


def configs(layers=4, d_model=1024, n_heads=8, d_ff=4096, vocab=8192, draft_layers=1,
            draft_d_model=256, draft_d_ff=1024, prompt_len=32, steps=64, k=4):
    """(target, draft) configurations as JAX's CLI makes them: room for the
    ``3·steps`` run and one round's k+1 tokens; the draft has n_heads // 4
    heads."""
    max_len = prompt_len + 3 * steps + k + 1
    tcfg = TernaryLMConfig(vocab=vocab, d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                           n_layers=layers, max_len=max_len)
    dcfg = TernaryLMConfig(vocab=vocab, d_model=draft_d_model, n_heads=max(1, n_heads // 4),
                           d_ff=draft_d_ff, n_layers=draft_layers, max_len=max_len)
    return tcfg, dcfg


def build(tcfg, dcfg, prompt_len, seed=0, device=None):
    """(target, draft, prompt): random weights from ``seed`` and ``seed + 1``,
    the prompt from ``seed + 2``, on the card unless ``device`` says."""
    target = pack_lm(init_lm(rng.make_generator(seed, device), tcfg))
    draft = pack_lm(init_lm(rng.make_generator(seed + 1, device), dcfg))
    gen = rng.make_generator(seed + 2, device)
    prompt = torch.randint(0, tcfg.vocab, (1, prompt_len), generator=gen, device=gen.device)
    return target, draft, prompt


def run_spec_bench(tcfg, dcfg, prompt_len=32, steps=64, k=4, reps=3, seed=0,
                   device=None) -> dict:
    """{row: {"us_per_token", ...}} for plain, spec-self and spec-draft."""
    target, draft, prompt = build(tcfg, dcfg, prompt_len, seed, device)
    kw = dict(compute_dtype=torch.bfloat16)

    def slope(run):
        lo = measure(lambda: run(steps), reps=reps).min_s
        hi = measure(lambda: run(3 * steps), reps=reps).min_s
        return (hi - lo) / (2 * steps)

    rows = {"plain": {"us_per_token": 1e6 * slope(
        lambda n: generate(target, prompt, tcfg, n, **kw))}}
    for name, d, d_cfg in (("spec-self", target, tcfg), ("spec-draft", draft, dcfg)):
        def run(n, d=d, d_cfg=d_cfg):
            return generate_speculative(target, d, prompt, tcfg, d_cfg, n, k=k, **kw)

        _, stats = generate_speculative(target, d, prompt, tcfg, d_cfg, steps, k=k,
                                        return_stats=True, **kw)
        rows[name] = {"us_per_token": 1e6 * slope(run), **stats}
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=4096)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--draft-layers", type=int, default=1)
    ap.add_argument("--draft-d-model", type=int, default=256)
    ap.add_argument("--draft-d-ff", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    tcfg, dcfg = configs(args.layers, args.d_model, args.n_heads, args.d_ff, args.vocab,
                         args.draft_layers, args.draft_d_model, args.draft_d_ff,
                         args.prompt_len, args.steps, args.k)
    rows = run_spec_bench(tcfg, dcfg, args.prompt_len, args.steps, args.k, args.reps)
    base = rows["plain"]["us_per_token"]
    print(f"spec bench on {torch.cuda.get_device_name(0)}", flush=True)
    print(f"plain      generate: {base:8.1f} us/tok", flush=True)
    for name in ("spec-self", "spec-draft"):
        r = rows[name]
        print(f"{name:<10} (k={args.k}): {r['us_per_token']:8.1f} us/tok "
              f"({base / r['us_per_token']:.2f}x vs plain; {r['rounds']} rounds, "
              f"mean accepted {r['mean_accepted']:.2f} of {args.k})", flush=True)
    return rows


if __name__ == "__main__":
    main()
