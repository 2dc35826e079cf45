"""Capacity-scale sweep: the reference's original full-size grid on the CUDA
card (counterpart of smmb_tpu/bench/capacity.py).

The reference's legacy benchmark shipped with its production grid
commented out: 8 paired cases up to M=64000, K=16384, N=4096. This module
runs that grid on one card with streamed M tiles:

* the weights live as one 2-bit ``TernaryPacked`` plane (the 16384×4096
  case is 16.8 MB packed against 268 MB of dense f32);
* the activations are bf16 and go through a Python loop over (bm, K)
  tiles, B1 in bf16 mode on each (the dense row: ``torch.matmul`` on the
  dense bf16 W), so the M=64000 pass holds X (2.1 GB) + Y (0.5 GB) + W;
* every case validates a row slice against an f64 dense oracle before it
  is timed.

Eager PyTorch hoists nothing out of the timed loop, so the X rotation that
JAX's measurement needs (XLA hoists the loop-invariant dense product out of
its scan) has no counterpart here.

CLI: ``python -m smmb_tpu_torch capacity [--csv out.csv] [--max-m M]``
(runs on the card).
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from smmb_tpu_torch.bench.flops import sparse_flops, spmm_bytes
from smmb_tpu_torch.bench.measure import measure
from smmb_tpu_torch.bench.roofline import chip_spec, roofline_bound
from smmb_tpu_torch.bench.sweep import DISPATCH_FLOOR_S, CaseResult
from smmb_tpu_torch.formats.packed import pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.device import resolve_device
from smmb_tpu_torch.utils.shapes import round_up

# the reference's original (commented-out) cases, paired, not a product
ORIGINAL_CASES = [
    (1, 512, 2048),
    (16, 1024, 4096),
    (64, 2048, 8192),
    (256, 4096, 16384),
    (1000, 2048, 512),
    (4000, 4096, 1024),
    (16000, 8192, 2048),
    (64000, 16384, 4096),
]
ORIGINAL_NON_ZERO = [2, 8, 16]


def _packed_tile(xi, w, bias):
    return packed_spmm(xi, w, bias, compute_dtype=torch.bfloat16)


def _dense_tile(xi, w, bias):
    # torch.matmul rounds the bf16 product to bf16 before the f32 bias
    # (JAX keeps it in f32 there); both are inside the bf16 tolerance
    return (torch.matmul(xi, w).float() + bias).to(xi.dtype)


def run_capacity_case(
    m: int,
    k: int,
    n: int,
    non_zero: int,
    *,
    bm: int = 8192,
    seed: int = 0,
    reps: int = 3,
    validate_rows: int = 64,
    device=None,
) -> list[CaseResult]:
    """One original-grid case on ``device`` (None = the CUDA card): build,
    validate a row slice, then time the streamed pass of the packed bf16
    kernel and of the dense bf16 product. On the CPU the rows are validated
    and their measurement error printed, with a NaN time."""
    dev = resolve_device(device)
    gen = rng.make_generator(seed, dev)
    w_dense = rng.rand_ternary(gen, (k, n), non_zero=non_zero)
    nnz = int(torch.count_nonzero(w_dense))
    p = pack_ternary_device(w_dense, nnz=nnz)
    b = rng.rand_dense(gen, (n,))

    bm_eff = min(round_up(m, 128), bm)
    nt = -(-m // bm_eff)
    mp = nt * bm_eff
    # bf16 activations (the serving dtype, 2 bytes an element); rows past
    # m are zero padding of the last tile
    x = rng.rand_dense(gen, (mp, k))
    x[m:] = 0.0
    x = x.to(torch.bfloat16)
    tiles = x.split(bm_eff)

    case = f"{m}x{k}x{n}@{1 / non_zero:.3g}"
    spec = chip_spec() if dev.type == "cuda" else None
    # f64 oracle on a row slice (a full-M oracle is TFLOPs at M=64000)
    vr = min(validate_rows, m)
    oracle = x[:vr].double() @ w_dense.double() + b.double()
    tol = 0.02 * max(1.0, float(oracle.abs().max()))  # bf16 inputs
    out = []
    for name, fn, w_arg, wbytes in (
        ("packed_kernel_bf16", _packed_tile, p, p.weight_bytes()),
        ("dense_bf16", _dense_tile, w_dense.to(torch.bfloat16), 2 * k * n),
    ):
        def run(fn=fn, w_arg=w_arg):
            return torch.cat([fn(t, w_arg, b) for t in tiles])

        try:
            err = float((run()[:vr].double() - oracle).abs().max())
        except Exception as e:  # a faulting row must not end the run
            print(f"[{case}] {name}: ERROR {type(e).__name__}: {str(e)[:120]}",
                  file=sys.stderr, flush=True)
            out.append(CaseResult(case, name, False, float("inf"), float("nan"),
                                  0, 0.0, 0.0, 0.0))
            continue
        if err > tol:
            out.append(CaseResult(case, name, False, err, float("nan"), 0, 0.0, 0.0, 0.0))
            print(f"[{case}] {name}: INVALID err={err:.3e}", file=sys.stderr, flush=True)
            continue
        work = sparse_flops(m, n, nnz)
        try:
            t_best = measure(run, reps=reps).min_s
        except Exception as e:
            print(f"[{case}] {name}: MEASURE ERROR {type(e).__name__}: {str(e)[:120]}",
                  file=sys.stderr, flush=True)
            out.append(CaseResult(case, name, True, err, float("nan"), work, 0.0, 0.0, 0.0))
            continue
        byt = spmm_bytes(m, n, k, weight_bytes=wbytes, x_itemsize=2, y_itemsize=2)
        sol, _ = roofline_bound(2.0 * m * n * k, byt, spec, "bf16")
        out.append(CaseResult(
            case, name, True, err, t_best, work, work / t_best, nnz * m / t_best,
            sol / t_best, dispatch_bound=t_best < DISPATCH_FLOOR_S,
        ))
        print(f"[{case}] {name:<20s} t={t_best * 1e6:10.1f}us "
              f"frac={sol / t_best:5.2f} err={err:.1e}", file=sys.stderr, flush=True)
    return out


def hbm_stats() -> str:
    """Peak allocated device memory of the current CUDA device against its
    total (the no-out-of-memory-at-capacity evidence)."""
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    return f"peak device memory {peak:.2f} GiB of {total / 2**30:.2f} GiB"


def main(argv=None):
    import argparse

    from smmb_tpu_torch.bench.report import Progress, plot_performance, to_csv

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--plot", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--bm", type=int, default=8192)
    ap.add_argument("--max-m", type=int, default=None,
                    help="skip cases with M beyond this")
    ap.add_argument("--non-zeros", default=None,
                    help="comma list overriding the 2,8,16 density grid")
    args = ap.parse_args(argv)

    nzs = ([int(v) for v in args.non_zeros.split(",")] if args.non_zeros
           else ORIGINAL_NON_ZERO)
    cases = [c for c in ORIGINAL_CASES if args.max_m is None or c[0] <= args.max_m]
    prog = Progress(len(cases) * len(nzs), label="capacity")
    results = []
    for nz in nzs:
        for m, k, n in cases:
            results += run_capacity_case(m, k, n, nz, bm=args.bm, reps=args.reps)
            prog.step()
    print(hbm_stats(), file=sys.stderr, flush=True)
    rows = [dataclasses.asdict(r) for r in results]
    if args.csv:
        to_csv(rows, args.csv)
        print(f"wrote {args.csv}")
    if args.plot:
        out = plot_performance(
            rows, args.plot, title="smmb_tpu capacity sweep (original SparseGEMM grid)")
        if out:
            print(f"wrote {out}")
    bad = [r for r in results if not r.valid]
    if bad:
        print(f"{len(bad)} INVALID rows", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
