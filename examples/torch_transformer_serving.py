#!/usr/bin/env python
"""Example on the PyTorch port (the counterpart of
examples/transformer_serving.py): serving a ternary transformer block with
packed 2-bit weights.

On the card by default (B1, B3 and the fused MLP kernels); ``--cpu`` runs
the plain versions on CPU tensors:

    python examples/torch_transformer_serving.py [--cpu]

``main`` returns 0 when the served output has the input's shape and is
finite, the claim JAX's example prints.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from smmb_tpu_torch.models.transformer import (  # noqa: E402
    TernaryBlockConfig,
    block_forward,
    init_block,
    pack_block,
)
from smmb_tpu_torch.utils import rng  # noqa: E402
from smmb_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="plain versions on CPU tensors")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    cfg = TernaryBlockConfig(d_model=512, n_heads=8, d_ff=2048, causal=True)
    packed = pack_block(init_block(rng.make_generator(0, dev), cfg))

    planes = [packed["w_up"], packed["w_down"]] + [packed["attn"][n]
                                                   for n in ("wq", "wk", "wv", "wo")]
    packed_bytes = sum(p.weight_bytes() for p in planes)
    dense_bytes = 4 * (2 * cfg.d_model * cfg.d_ff + 4 * cfg.d_model ** 2)
    print(f"block weights: {packed_bytes / 1024:.0f} KiB packed "
          f"vs {dense_bytes / 1024:.0f} KiB dense fp32 "
          f"({dense_bytes / packed_bytes:.1f}x smaller)")

    x = rng.rand_dense(rng.make_generator(1, dev), (2, 64, cfg.d_model))
    y = block_forward(packed, x, cfg)
    finite = bool(torch.isfinite(y).all())
    print(f"served {x.shape[0] * x.shape[1]} tokens -> {tuple(y.shape)}, finite: {finite}")
    return 0 if finite and y.shape == x.shape else 1


if __name__ == "__main__":
    raise SystemExit(main())
