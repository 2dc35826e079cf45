"""End-to-end LM generation benchmark on the CUDA card (counterpart of
smmb_tpu/bench/lm_bench.py).

Times the whole serving loop of ``models/lm.generate`` — embeddings, N
packed transformer blocks with KV caches, RMSNorm, the packed LM head and
token selection — and reports µs/token and tok/s from the slope between
``steps`` and ``3·steps`` decode steps, each timed between CUDA events
(bench/measure.py). The slope cancels the prefill and the fixed cost of a
call. The loop is eager, so launch gaps on the host count in the time.

CLI: python -m smmb_tpu_torch lm [--layers 4] [--d-model 1024] [--n-heads 8]
     [--kv-heads N] [--d-ff 4096] [--vocab 8192] [--batch 1]
     [--prompt-len 32] [--steps 64] [--temperature T] [--reps 5]
     [--rope] [--window W]
The JAX CLI's --kv-quant, --flash, --experts and --top-k (experts per
token) belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from smmb_tpu_torch.bench.measure import measure
from smmb_tpu_torch.models.lm import TernaryLMConfig, generate, init_lm, pack_lm
from smmb_tpu_torch.utils import rng


@dataclasses.dataclass(frozen=True)
class LMBenchResult:
    per_token_s: float
    tokens_per_s: float
    lo_s: float
    hi_s: float


def build_lm(cfg: TernaryLMConfig, batch: int, prompt_len: int, seed: int = 0,
             device=None):
    """(packed, prompt): random weights and prompt from ``seed`` on the card."""
    gen = rng.make_generator(seed, device)
    packed = pack_lm(init_lm(gen, cfg))
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=gen.device)
    return packed, prompt


def run_lm_bench(cfg: TernaryLMConfig, batch: int = 1, prompt_len: int = 32,
                 steps: int = 64, temperature: float = 0.0, reps: int = 3,
                 seed: int = 0, device=None) -> LMBenchResult:
    """Per-token decode time: (t(3·steps) − t(steps)) / (2·steps), bf16
    compute and cache, as ``python -m smmb_tpu lm`` serves."""
    packed, prompt = build_lm(cfg, batch, prompt_len, seed, device)
    sample_gen = rng.make_generator(seed + 2, prompt.device)

    def timed(n_steps):
        def fn():
            return generate(packed, prompt, cfg, n_steps,
                            compute_dtype=torch.bfloat16,
                            temperature=temperature, generator=sample_gen)

        return measure(fn, reps=reps).min_s

    lo, hi = timed(steps), timed(3 * steps)
    per_tok = (hi - lo) / (2 * steps)
    return LMBenchResult(per_tok, batch / per_tok, lo, hi)


def config_from_args(args) -> TernaryLMConfig:
    return TernaryLMConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        d_ff=args.d_ff, n_layers=args.layers,
        max_len=args.prompt_len + 3 * args.steps, n_kv_heads=args.kv_heads,
        rope=args.rope, window=args.window,
    )


def parser():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=None)
    ap.add_argument("--d-ff", type=int, default=4096)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rope", action="store_true")
    ap.add_argument("--window", type=int, default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = config_from_args(args)
    r = run_lm_bench(cfg, args.batch, args.prompt_len, args.steps,
                     temperature=args.temperature, reps=args.reps)
    print(
        f"lm-generate on {torch.cuda.get_device_name(0)}: layers={args.layers} "
        f"d={args.d_model} ff={args.d_ff} vocab={args.vocab} batch={args.batch} "
        f"kv={cfg.block.attn.kv_heads}{' rope' if args.rope else ''}"
        f"{f' win{args.window}' if args.window else ''}"
        f"  {r.per_token_s * 1e6:.1f}us/tok = {r.tokens_per_s:.0f} tok/s "
        f"(slope {args.steps}->{3 * args.steps} steps; "
        f"lo={r.lo_s * 1e3:.2f}ms hi={r.hi_s * 1e3:.2f}ms)"
    )


if __name__ == "__main__":
    main()
