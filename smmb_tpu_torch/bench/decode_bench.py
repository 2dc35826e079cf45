"""Batch-1 incremental-decode benchmark on the CUDA card (counterpart of
smmb_tpu/bench/decode_bench.py).

L packed transformer blocks (bf16 compute, ``quantize=True`` packing) are
prefilled with a ``prompt_len`` prompt, then stepped one token at a time
against their preallocated KV caches. Reports the step latency and tok/s
from the slope between 16 and 48 steps (each run timed between CUDA
events, bench/measure.py; every run restarts from the prefilled caches),
the prefill time, and the byte-roofline fraction: per step the card must
read every packed weight plane once and the live KV prefix (pos + 1 cached
tokens), both at the memory rate. ``--flash`` reads the caches in the
decode steps through the flash-decode kernel B4 (the prefill is unchanged,
as in JAX).

CLI: python -m smmb_tpu_torch decode [--layers 4] [--d-model 1024]
     [--d-ff 4096] [--batch 1] [--max-len 1024] [--prompt-len 512]
     [--cache-dtype bf16] [--flash]
"""

from __future__ import annotations

import dataclasses

import torch

from smmb_tpu_torch.bench.measure import measure
from smmb_tpu_torch.bench.roofline import chip_spec
from smmb_tpu_torch.models.transformer import (
    TernaryBlockConfig,
    block_decode_step,
    block_prefill,
    init_block,
    init_block_cache,
    pack_block,
)
from smmb_tpu_torch.utils import rng


@dataclasses.dataclass(frozen=True)
class DecodeBenchResult:
    step_s: float
    tokens_per_s: float
    frac_roofline: float
    bound_s: float
    prefill_s: float
    prefill_tokens_per_s: float


def step_bytes(layers, d_model, d_ff, batch, prompt_len, cache_itemsize) -> int:
    """Bytes a decode step must move: the 2-bit planes once and the live
    K/V prefix (JAX decode_bench.py:146-154)."""
    wbytes = layers * (4 * d_model * d_model + 2 * d_model * d_ff) // 4
    kv_bytes = layers * 2 * batch * (prompt_len + 1) * d_model * cache_itemsize
    return wbytes + kv_bytes


def build_decoder(layers=4, d_model=1024, n_heads=8, d_ff=4096, batch=1,
                  max_len=1024, prompt_len=512, *, cache_dtype=torch.bfloat16,
                  compute_dtype=torch.bfloat16, device=None, use_flash=False):
    """(prefill, prompt, steps): packed blocks and a prompt from seed 0,
    ``prefill(x)`` that fills new caches, and ``steps(n)`` that runs n
    decode steps from the prompt's filled caches (each call restarts at the
    prompt end and overwrites the same cache slots)."""
    cfg = TernaryBlockConfig(d_model=d_model, n_heads=n_heads, d_ff=d_ff)
    gen = rng.make_generator(0, device)
    blocks = [pack_block(init_block(gen, cfg), quantize=True) for _ in range(layers)]
    kw = dict(compute_dtype=compute_dtype)
    dev = gen.device

    def prefill(x):
        caches = []
        for blk in blocks:
            c = init_block_cache(cfg, batch, max_len, dtype=cache_dtype, device=dev)
            x, c = block_prefill(blk, x, c, cfg, **kw)
            caches.append(c)
        return x, caches

    prompt = rng.rand_dense(gen, (batch, prompt_len, d_model))
    _, filled = prefill(prompt)
    x_t = rng.rand_dense(gen, (batch, 1, d_model))

    def steps(n):
        caches = [dict(c) for c in filled]  # same buffers, pos at the prompt end
        x = x_t
        for _ in range(n):
            h, new = x, []
            for blk, c in zip(blocks, caches):
                h, c = block_decode_step(blk, h, c, cfg, use_flash=use_flash, **kw)
                new.append(c)
            # the next step's input follows this one (JAX decode_bench.py)
            x, caches = x + h * 1e-6, new
        return x

    return prefill, prompt, steps


def run_decode_bench(layers=4, d_model=1024, n_heads=8, d_ff=4096, batch=1,
                     max_len=1024, prompt_len=512, *, cache_dtype=torch.bfloat16,
                     reps=4, n0=16, device=None,
                     use_flash: bool = False) -> DecodeBenchResult:
    prefill, prompt, steps = build_decoder(
        layers, d_model, n_heads, d_ff, batch, max_len, prompt_len,
        cache_dtype=cache_dtype, device=device, use_flash=use_flash)
    if prompt_len + 3 * n0 > max_len:
        raise ValueError(f"prompt_len + {3 * n0} steps exceeds max_len={max_len}")
    pre = measure(prefill, prompt, reps=reps)
    lo = measure(steps, n0, reps=reps).min_s
    hi = measure(steps, 3 * n0, reps=reps).min_s
    step_s = max((hi - lo) / (2 * n0), 1e-9)
    itemsize = torch.empty((), dtype=cache_dtype).element_size()
    bound_s = step_bytes(layers, d_model, d_ff, batch, prompt_len, itemsize) / (
        chip_spec().hbm_gbps * 1e9)
    return DecodeBenchResult(
        step_s=step_s, tokens_per_s=batch / step_s, frac_roofline=bound_s / step_s,
        bound_s=bound_s, prefill_s=pre.min_s,
        prefill_tokens_per_s=batch * prompt_len / pre.min_s,
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--cache-dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--flash", action="store_true",
                    help="decode attention via the flash-decode kernel B4")
    args = ap.parse_args(argv)
    r = run_decode_bench(
        args.layers, args.d_model, args.n_heads, args.d_ff, args.batch,
        args.max_len, args.prompt_len,
        cache_dtype=torch.bfloat16 if args.cache_dtype == "bf16" else torch.float32,
        reps=args.reps, use_flash=args.flash,
    )
    print(
        f"decode on {torch.cuda.get_device_name(0)}: layers={args.layers} "
        f"d={args.d_model} ff={args.d_ff} batch={args.batch} "
        f"ctx={args.prompt_len}/{args.max_len}{' flash' if args.flash else ''}  step={r.step_s * 1e6:.1f}us  "
        f"tok/s={r.tokens_per_s:.0f}  frac={r.frac_roofline:.3f} "
        f"(bound {r.bound_s * 1e6:.2f}us)  prefill={r.prefill_s * 1e6:.1f}us "
        f"({r.prefill_tokens_per_s / 1e6:.2f}M tok/s)"
    )


if __name__ == "__main__":
    main()
