#!/usr/bin/env python
"""One LM batch against its two halves (the split a 2-rank DP step makes)
on the PyTorch port alone, on the card by default (``--cpu``: CPU tensors).

At the ``lm`` CLI's widths (4 layers, d_model 1024, 8 heads, d_ff 4096,
vocab 8192; ``--small``: 2 layers of 128) on LeCun-scale masters (every
projection and the head over sqrt(fan_in), chip_smoke.py's ``_lecun``;
``init_lm`` at seed 11, as phase 28) and 4 rows of 128 tokens, it prints
one JSON line a reading, each the worst leaf's max|a − b| over the largest
|b| and that leaf:

- ``forward_rows``: the QAT logits of the first half's rows, computed in
  the half and in the whole batch (over max|logit|);
- ``repeat``: the whole batch's gradients, taken twice (determinism);
- ``split``: the mean of the halves' gradients against the whole batch's,
  as phase 28 reads it;
- the same three again with ``torch.set_float32_matmul_precision("highest")``
  and cuDNN's TF32 off (``_highest``).

    python scripts/torch_dp_split_card.py [--cpu] [--small]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from chip_smoke import _lecun  # noqa: E402
from smmb_tpu_torch.models.lm import TernaryLMConfig, init_lm, lm_loss, qat_lm_forward  # noqa: E402
from smmb_tpu_torch.models.train import param_leaves  # noqa: E402
from smmb_tpu_torch.utils import rng  # noqa: E402
from smmb_tpu_torch.utils.device import resolve_device  # noqa: E402

LM = dict(vocab=8192, d_model=1024, n_heads=8, d_ff=4096, n_layers=4)
SMALL = dict(vocab=256, d_model=128, n_heads=4, d_ff=256, n_layers=2)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _named(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _grads(cfg, masters, tokens):
    params = _clone(masters)
    for q in param_leaves(params):
        q.requires_grad_(True)
    lm_loss(params, tokens, cfg).backward()
    return [(n, torch.zeros_like(q) if q.grad is None else q.grad.detach())
            for n, q in _named(params)]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _parted(a, b):
    """(worst leaf's max|a − b| over the largest |b|, its name)."""
    bmax = max(float(g.abs().max()) for _, g in b)
    return max((float((x - y).abs().max()) / bmax, n) for (n, x), (_, y) in zip(a, b))


def readings(cfg, masters, tokens, suffix="") -> dict:
    half = tokens.shape[0] // 2
    with torch.no_grad():
        whole_logits = qat_lm_forward(masters, tokens, cfg)[:half]
        half_logits = qat_lm_forward(masters, tokens[:half], cfg)
    rows = float((whole_logits - half_logits).abs().max()) / float(whole_logits.abs().max())
    whole = _grads(cfg, masters, tokens)
    again = _grads(cfg, masters, tokens)
    a, b = _grads(cfg, masters, tokens[:half]), _grads(cfg, masters, tokens[half:])
    mean = [(n, (x + y) / 2) for (n, x), (_, y) in zip(a, b)]
    return {"forward_rows" + suffix: [rows, "logits"],
            "repeat" + suffix: list(_parted(again, whole)),
            "split" + suffix: list(_parted(mean, whole))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="CPU tensors")
    ap.add_argument("--small", action="store_true", help="2 layers of 128")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    seq = 128
    cfg = TernaryLMConfig(**(SMALL if args.small else LM), max_len=seq)
    masters = _lecun(init_lm(rng.make_generator(11, dev), cfg))
    tokens = torch.randint(0, cfg.vocab, (4, seq), generator=rng.make_generator(9, dev),
                           device=dev)
    out = {"device": str(dev) if dev.type == "cpu" else torch.cuda.get_device_name(dev),
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision()}
    out.update(readings(cfg, masters, tokens))
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    out.update(readings(cfg, masters, tokens, "_highest"))
    for k, v in out.items():
        print(json.dumps({k: v}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
