"""CLI: ``python -m smmb_tpu_torch {mlp,headline}`` — runs on the CUDA card.

- ``mlp``: the packed MLP serving benchmark (bench/mlp_bench.py);
- ``headline``: the packed SpMM headline JSON line (bench/headline.py).
"""

import sys


def main():
    args = sys.argv[1:]
    mode = args[0] if args else ""
    rest = args[1:]
    if mode == "mlp":
        from smmb_tpu_torch.bench.mlp_bench import main as mlp_main

        mlp_main(rest)
    elif mode == "headline":
        from smmb_tpu_torch.bench.headline import main as headline_main

        sys.exit(headline_main())
    else:
        print(__doc__)
        sys.exit(2)


if __name__ == "__main__":
    main()
