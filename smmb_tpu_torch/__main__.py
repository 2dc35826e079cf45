"""CLI: ``python -m smmb_tpu_torch {mlp,headline,lm,decode}`` — runs on the
CUDA card.

- ``mlp``: the packed MLP serving benchmark (bench/mlp_bench.py);
- ``headline``: the packed SpMM headline JSON line (bench/headline.py);
- ``lm``: the ternary LM's ``generate``, µs/token (bench/lm_bench.py);
- ``decode``: the block-level decode step and its roofline fraction
  (bench/decode_bench.py).
"""

import sys


def main():
    args = sys.argv[1:]
    mode = args[0] if args else ""
    rest = args[1:]
    if mode == "mlp":
        from smmb_tpu_torch.bench.mlp_bench import main as mlp_main

        mlp_main(rest)
    elif mode == "lm":
        from smmb_tpu_torch.bench.lm_bench import main as lm_main

        lm_main(rest)
    elif mode == "decode":
        from smmb_tpu_torch.bench.decode_bench import main as decode_main

        decode_main(rest)
    elif mode == "headline":
        from smmb_tpu_torch.bench.headline import main as headline_main

        sys.exit(headline_main())
    else:
        print(__doc__)
        sys.exit(2)


if __name__ == "__main__":
    main()
