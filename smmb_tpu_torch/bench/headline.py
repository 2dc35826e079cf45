"""Headline benchmark of the port: packed SpMM fraction of the card's roofline.

BASELINE.json config 1 on the CUDA card: 4096×4096 ternary weights at ~10%
nnz against dense batch-256 f32 activations, through the serving path
(``packed_spmm`` with bf16 compute and f32 accumulation).

Prints ONE JSON line in bench.py's schema:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
with bench.py's definition of the value: the two-ceiling roofline (dense
2·M·N·K operations at the bf16 tensor-core peak against X, packed W, bias
and Y moved once) over the best measured time, and vs_baseline the value
over the 0.80 target of BASELINE.md. The ceilings are this card's
(``bench/roofline.py``).

CLI: python -m smmb_tpu_torch.bench.headline
"""

from __future__ import annotations

import json
import sys

import torch

from smmb_tpu_torch.bench.flops import sparse_flops, spmm_bytes
from smmb_tpu_torch.bench.measure import measure
from smmb_tpu_torch.bench.roofline import chip_spec, roofline_bound
from smmb_tpu_torch.formats.packed import pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.utils import rng

M, K, N = 256, 4096, 4096
NON_ZERO = 10  # expected density 1/10 (BASELINE.json: "~10% nnz")
TARGET_FRAC = 0.80  # BASELINE.md per-chip roofline target


def main() -> int:
    gen = rng.make_generator(0)
    x = rng.rand_dense(gen, (M, K))
    w = rng.rand_ternary(gen, (K, N), non_zero=NON_ZERO)
    b = rng.rand_dense(gen, (N,))
    p = pack_ternary_device(w, nnz=int(torch.count_nonzero(w)))

    meas = measure(
        lambda: packed_spmm(x, p, b, compute_dtype=torch.bfloat16), reps=8
    )
    spec = chip_spec()
    sol, _ = roofline_bound(
        2.0 * M * N * K, spmm_bytes(M, N, K, weight_bytes=p.weight_bytes()),
        spec, "bf16",
    )
    t_best = meas.min_s
    frac = sol / t_best
    nnz_per_s = p.nnz * M / t_best
    eff_flops = sparse_flops(M, N, p.nnz) / t_best
    result = {
        "metric": "tcsc_spmm_frac_roofline",
        "value": round(frac, 4),
        "unit": f"fraction of {spec.name} roofline on "
        f"{torch.cuda.get_device_name(0)} "
        f"(best {t_best * 1e6:.1f}us, mean {meas.mean_s * 1e6:.1f}us, "
        f"{nnz_per_s / 1e9:.1f}Gnnz/s, "
        f"{eff_flops / 1e12:.2f}T eff FLOP/s, M={M} K={K} N={N} d={p.density:.2f})",
        "vs_baseline": round(frac / TARGET_FRAC, 4),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
