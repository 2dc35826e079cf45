#!/usr/bin/env python
"""End-to-end example on the PyTorch port (the counterpart of
examples/train_and_serve.py): train a ternary MLP with STE, convert it to
the 2-bit serving format, serve it through the packed kernel B1, and save
and load the artifact.

On the card by default; ``--cpu`` runs the plain versions on CPU tensors.
``--out`` names the artifact (JAX's example writes /tmp/ternary_mlp.npz):

    python examples/torch_train_and_serve.py [--cpu] [--out PATH]

``main`` returns 0 when the served output is finite and the loaded
artifact serves it again bitwise.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from smmb_tpu_torch import io as smio  # noqa: E402
from smmb_tpu_torch.models.mlp import TernaryMLPConfig, mlp_forward, pack_mlp  # noqa: E402
from smmb_tpu_torch.models.train import make_train_step  # noqa: E402
from smmb_tpu_torch.utils import rng  # noqa: E402
from smmb_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="plain versions on CPU tensors")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "ternary_mlp.npz"),
                    help="where the serving artifact is written")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    cfg = TernaryMLPConfig(layer_dims=(64, 128, 64), alpha=0.2)
    gen = rng.make_generator(0, dev)
    # fp32 master weights (start near-ternary like a quantized init)
    params = {
        "w": [0.3 * rng.rand_dense(gen, (cfg.layer_dims[i], cfg.layer_dims[i + 1]))
              for i in range(cfg.num_layers)],
        "b": [torch.zeros((d,), device=dev) for d in cfg.layer_dims[1:]],
    }
    x = rng.rand_dense(gen, (256, 64))
    y = rng.rand_dense(gen, (256, 64))

    init_opt, step = make_train_step(alpha=cfg.alpha, learning_rate=3e-3)
    opt_state = init_opt(params)
    for i in range(50):
        params, opt_state, loss = step(params, opt_state, x, y)
        if i % 10 == 0:
            print(f"step {i:3d}  loss {float(loss):.5f}")

    with torch.no_grad():
        # ----- convert: QAT rule (absmean scale x ternarized masters) -> packed
        packed = pack_mlp(params, quantize=True)
        packed["b"] = [b.detach() for b in packed["b"]]
        for i, w in enumerate(packed["w"]):
            print(f"layer {i}: packed {tuple(w.data.shape)} int8 "
                  f"({w.weight_bytes()} B vs {4 * w.rows * w.cols} B dense fp32)")

        # ----- serve (B1 on the card, its plain version on the CPU)
        out = mlp_forward(packed, x, cfg)
        finite = bool(torch.isfinite(out).all())
        print("serving output:", tuple(out.shape), "finite:", finite)

        # ----- save / load the serving artifact
        smio.save_packed_mlp(args.out, packed)
        back = smio.load_packed_mlp(args.out, device=dev)
        same = torch.equal(out, mlp_forward(back, x, cfg))
    print(f"artifact round-trip bitwise: {same} -> {args.out}")
    return 0 if finite and same else 1


if __name__ == "__main__":
    raise SystemExit(main())
