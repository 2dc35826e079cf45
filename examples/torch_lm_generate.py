#!/usr/bin/env python
"""End-to-end example on the PyTorch port (the counterpart of
examples/lm_generate.py): train a tiny ternary LM with STE, pack it to the
2-bit serving format, and greedy-generate with the KV-cache decode path.

On the card by default (B1 and the fused kernels serve it); ``--cpu`` runs
the plain versions on CPU tensors:

    python examples/torch_lm_generate.py [--cpu]

``main`` returns 0 when the training loss fell and the continuation has
the asked shape; the pattern accuracy is printed, as JAX's example prints it.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from smmb_tpu_torch.models.lm import (  # noqa: E402
    TernaryLMConfig,
    generate,
    init_lm,
    make_lm_train_step,
    pack_lm,
)
from smmb_tpu_torch.utils import rng  # noqa: E402
from smmb_tpu_torch.utils.device import resolve_device  # noqa: E402


def _shifted(tree, by: float):
    """Every tensor of a master tree plus ``by`` (non-degenerate f32 masters
    for STE training, as JAX's example adds 0.01)."""
    if isinstance(tree, dict):
        return {k: _shifted(v, by) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shifted(v, by) for v in tree]
    return tree + by


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="plain versions on CPU tensors")
    ap.add_argument("--steps", type=int, default=60, help="training steps")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    cfg = TernaryLMConfig(vocab=64, d_model=64, n_heads=2, d_ff=128, n_layers=2, max_len=64)
    params = _shifted(init_lm(rng.make_generator(0, dev), cfg), 0.01)

    # ----- "data": memorize a repeating token pattern
    pattern = torch.arange(32, device=dev) % 8
    toks = pattern.repeat(8, 1)  # (8, 32)

    init_opt, step = make_lm_train_step(cfg, learning_rate=3e-3)
    opt_state = init_opt(params)
    losses = []
    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(float(loss))
        if i % 15 == 0:
            print(f"step {i:3d}  xent {losses[-1]:.4f}")

    with torch.no_grad():
        # ----- convert: QAT rule -> 2-bit packed blocks + head
        packed = pack_lm(params, quantize=True)
        w = packed["blocks"][0]["attn"]["wq"]
        print(f"packed wq: {tuple(w.data.shape)} int8 "
              f"({w.weight_bytes()} B vs {4 * w.rows * w.cols} B dense fp32)")

        # ----- serve: prefill + per-step greedy decode on the card's kernels
        prompt = pattern[None, :8]
        out = generate(packed, prompt, cfg, steps=16)
    print("prompt:      ", prompt[0].tolist())
    print("continuation:", out[0].tolist())
    # a well-trained LM continues the period-8 pattern
    want = torch.arange(8, 24, device=dev) % 8
    acc = float((out[0] == want).float().mean())
    print(f"pattern accuracy: {acc * 100:.0f}%")

    fell = losses[-1] < losses[0]
    print(f"training loss fell: {fell} ({losses[0]:.4f} -> {losses[-1]:.4f})")
    ok = fell and tuple(out.shape) == (1, 16) and bool(((out >= 0) & (out < cfg.vocab)).all())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
