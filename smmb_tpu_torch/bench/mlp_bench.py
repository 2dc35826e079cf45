"""Multi-layer ternary MLP serving benchmark on the CUDA card
(counterpart of smmb_tpu/bench/mlp_bench.py; BASELINE.json config 5).

Measures the packed MLP forward end to end: one packed SpMM launch per layer
with fused bias and PReLU. Reports rows/s (batch rows through the full
depth), effective nnz/s, and the fraction of the card's roofline for the
whole forward (the sparse operations at the compute dtype's peak against
the bytes: packed weights and biases once, each layer's input and output).

On an explicit ``device="cpu"`` the forward runs the plain versions, timed
by the host's clock (``measure_host``), with no bound: a smoke of the
harness, not a measurement of the card.

CLI: python -m smmb_tpu_torch mlp [--depth 4] [--dim 4096] [--batch 256]
"""

from __future__ import annotations

import dataclasses

import torch

from smmb_tpu_torch.bench.measure import HOST_CALLS, measure, measure_host
from smmb_tpu_torch.bench.roofline import chip_spec, roofline_bound
from smmb_tpu_torch.models.mlp import TernaryMLPConfig, init_mlp, mlp_forward, pack_mlp
from smmb_tpu_torch.utils import rng



@dataclasses.dataclass(frozen=True)
class MLPBenchResult:
    label: str
    mean_s: float
    min_s: float
    rows_per_s: float
    nnz_per_s: float
    bound_s: float
    bound_by: str
    frac_roofline: float


def build_mlp(depth: int, dim: int, batch: int, non_zero: int, device=None):
    """(cfg, packed, x, total_nnz): random model and input from seed 0, on
    the card."""
    gen = rng.make_generator(0, device)
    cfg = TernaryMLPConfig(layer_dims=(dim,) * (depth + 1), non_zero=non_zero)
    params = init_mlp(gen, cfg)
    total_nnz = sum(int(torch.count_nonzero(w)) for w in params["w"])
    packed = pack_mlp(params)
    x = rng.rand_dense(gen, (batch, dim))
    return cfg, packed, x, total_nnz


def run_mlp_bench(
    depth: int = 4,
    dim: int = 4096,
    batch: int = 256,
    non_zero: int = 10,
    *,
    reps: int = 4,
    use_kernel: bool = True,
    device=None,
) -> MLPBenchResult:
    """Time the bf16 forward (the serving mode) through the kernel, or
    through the plain path with ``use_kernel=False``; ``device`` None is the
    card (``device="cpu"``: host-timed plain versions, bound NaN)."""
    cfg, packed, x, total_nnz = build_mlp(depth, dim, batch, non_zero, device)

    def fn(x):
        return mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16,
                           use_kernel=use_kernel)

    if x.device.type == "cpu":
        bound_s, bound_by = float("nan"), "not measured"
        meas = measure_host(fn, x, calls=HOST_CALLS, reps=reps)
    else:
        ops = 2.0 * batch * total_nnz + batch * dim * depth
        bytes_moved = (
            sum(w.weight_bytes() for w in packed["w"])
            + 4 * dim * depth  # f32 biases
            + 2 * depth * batch * dim * x.element_size()  # each layer's in and out
        )
        bound_s, bound_by = roofline_bound(ops, bytes_moved, chip_spec(), "bf16")
        meas = measure(fn, x, reps=reps)
    t = meas.min_s
    return MLPBenchResult(
        label="kernel" if use_kernel else "plain",
        mean_s=meas.mean_s,
        min_s=t,
        rows_per_s=batch / t,
        nnz_per_s=total_nnz * batch / t,
        bound_s=bound_s,
        bound_by=bound_by,
        frac_roofline=bound_s / t,
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    r = run_mlp_bench(args.depth, args.dim, args.batch)
    print(
        f"{r.label} on {torch.cuda.get_device_name(0)}: depth={args.depth} "
        f"dim={args.dim} batch={args.batch}  t={r.min_s * 1e6:.1f}us  "
        f"rows/s={r.rows_per_s:.3e}  nnz/s={r.nnz_per_s:.3e}  "
        f"frac={r.frac_roofline:.3f} ({r.bound_by}-bound)"
    )


if __name__ == "__main__":
    main()
