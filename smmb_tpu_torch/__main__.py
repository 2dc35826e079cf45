"""CLI: ``python -m smmb_tpu_torch
{showcase,sweep,capacity,scaling,mlp,headline,lm,decode,spec}`` — runs on the
CUDA card. Every mode prints a provenance stamp first (utils/stamp.py).

- ``showcase`` (the default) and ``sweep``: the reference
  benchmark, every format and kernel row validated against the dense oracle,
  then timed (bench/sweep.py; ``--csv``, ``--plot``, ``--iters``,
  ``--reps``, ``--seed``, ``--kernels``, ``--cases``, ``--config``);
- ``capacity``: the reference's original full-size grid with streamed M
  tiles through B1 (bench/capacity.py; ``--bm``, ``--max-m``,
  ``--non-zeros``, ``--reps``, ``--csv``, ``--plot``);
- ``mlp``: the packed MLP serving benchmark (bench/mlp_bench.py);
- ``headline``: the packed SpMM headline JSON line (bench/headline.py);
- ``lm``: the ternary LM's ``generate``, µs/token (bench/lm_bench.py;
  ``--flash`` for the flash kernels B9 and B4, ``--kv-quant`` for the int8
  KV cache through B7 and B8);
- ``decode``: the block-level decode step and its roofline fraction
  (bench/decode_bench.py; ``--flash`` reads the caches through B4);
- ``spec``: speculative decoding against plain ``generate``, µs/token of
  plain, spec-self and spec-draft (bench/spec_bench.py);
- ``scaling``: the sharded products' nnz/s and scaling efficiency over
  growing meshes of ranks (bench/scaling.py; ``--mesh 1x1,1x2``,
  ``--partitionings``, ``--reps``, ``--config``);
  points whose ranks share a card are labelled as such.
"""

import sys


def main():
    from smmb_tpu_torch.utils.stamp import print_stamp

    print_stamp()  # every output records the commit it measured
    args = sys.argv[1:]
    mode = args[0] if args else "showcase"
    rest = args[1:]
    if mode in ("showcase", "sweep"):
        from smmb_tpu_torch.bench.sweep import main as sweep_main

        sys.exit(sweep_main([mode] + rest))
    elif mode == "capacity":
        from smmb_tpu_torch.bench.capacity import main as capacity_main

        sys.exit(capacity_main(rest))
    elif mode == "scaling":
        from smmb_tpu_torch.bench.scaling import main as scaling_main

        sys.exit(scaling_main(rest))
    elif mode == "mlp":
        from smmb_tpu_torch.bench.mlp_bench import main as mlp_main

        mlp_main(rest)
    elif mode == "lm":
        from smmb_tpu_torch.bench.lm_bench import main as lm_main

        lm_main(rest)
    elif mode == "decode":
        from smmb_tpu_torch.bench.decode_bench import main as decode_main

        decode_main(rest)
    elif mode == "spec":
        from smmb_tpu_torch.bench.spec_bench import main as spec_main

        spec_main(rest)
    elif mode == "headline":
        from smmb_tpu_torch.bench.headline import main as headline_main

        sys.exit(headline_main())
    else:
        print(__doc__)
        sys.exit(2)


if __name__ == "__main__":
    main()
