"""The reference benchmark's two entries on the CUDA card
(counterpart of smmb_tpu/bench/sweep.py).

* ``SHOWCASE_CASES`` / ``run_showcase``: the reference's main.cpp
  showcase, a fixed {M, K, N} list at 50% density, every kernel variant
  validated and then timed, an ASCII table and a speedup analysis.
* ``run_sweep``: the reference's SparseGEMM.cpp size × sparsity sweep
  (M × K × N × non_zero grid), CSV output.

Both validate before they measure: a row that misses the dense oracle is
reported INVALID and not timed, and a row that raises is printed and
reported INVALID so the CSV keeps it (chip_smoke.py fails on either).

Row names are JAX's, so CSVs compare row by row, with one exception: JAX's
``bcsr_pallas`` (kernel B2 on the TPU) is ``bcsr_kernel`` here (B2 on the
card). The kernel rows, ``packed_kernel*`` (B1) and ``bcsr_kernel`` (B2),
appear only on a CUDA device, as JAX's appear only on the TPU
(``use_pallas``); on the CPU the registry is JAX's ``use_pallas=False``
one. ``tcsc_segsum`` takes the ragged ``tcsc_spmm`` on every device (JAX
takes the padded layout on the TPU to avoid a Mosaic fault that has no
counterpart here); ``tcsc_padded`` stays its own row.

Times come from ``bench.measure.measure`` (CUDA events, ``min_s``). The
roofline fraction keeps JAX's formula: 2·M·N·K operations at the peak of
the row's dtype against X, W, bias and Y bytes, through
``bench.roofline.roofline_bound``, at the rate ``row_ceiling`` names: a
row with "bf16" in its name takes the bf16 rate and a ``w2a8`` row (int8 X
on the int8 tensor cores) the int8 rate; every other row multiplies f32 X
by the ternary W, which the card does exactly as three bf16 passes, so it
takes ``"f32_ternary"`` (the bf16 rate over three; JAX's f32 CUDA-core
ceiling would let B2's mma body read above 1).

CLI: ``python -m smmb_tpu_torch {showcase,sweep} [--csv out.csv] ...``
(runs on the card).
"""

from __future__ import annotations

import dataclasses
import itertools
import sys

import numpy as np
import torch

from smmb_tpu_torch.bench.flops import dense_flops, sparse_flops, spmm_bytes
from smmb_tpu_torch.bench.measure import measure
from smmb_tpu_torch.bench.report import Progress, results_table, speedup_analysis, to_csv
from smmb_tpu_torch.bench.roofline import chip_spec, roofline_bound
from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.formats.tcsc import tcsc_from_dense, tcsc_pad_columns
from smmb_tpu_torch.kernels.bcsr_spmm import bcsr_prepare, bcsr_spmm_kernel
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.ops import (
    bcsr_spmm,
    gemm,
    gemm_prelu,
    packed_spmm_ref,
    tcsc_spmm,
    tcsc_spmm_padded,
    tcsc_spmm_prelu,
)
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.compare import TOL_DENSE, compare
from smmb_tpu_torch.utils.device import resolve_device

ALPHA = 0.2  # the reference showcase's PReLU slope (main.cpp)
LEGACY_ALPHA = 0.25  # the reference's legacy sweep's (SparseGEMM.cpp)
# Calls faster than this are labelled ``dispatch_bound``: the fixed cost of
# a launch, not the kernel, sets their time, and frac_roofline misreads as a
# loss there. The threshold is JAX's; the card's own launch floor is not
# measured here.
DISPATCH_FLOOR_S = 10e-6

# the reference showcase's (M, K, N) list, 50% density
SHOWCASE_CASES = [
    (1, 512, 2048),
    (1, 1024, 4096),
    (16, 512, 2048),
    (64, 1024, 4096),
    (256, 1024, 4096),
]

# the reference sweep's grids
SWEEP_M = [1, 16, 64]
SWEEP_K = [256, 512, 1024]
SWEEP_N = [512, 1024, 2048]
SWEEP_NON_ZERO = [2, 8, 16]

_PACKED_ROWS = (
    "packed_jnp", "packed_kernel", "packed_kernel_prelu", "packed_kernel_bf16",
    "packed_kernel_bf16_prelu", "packed_kernel_w2a8", "packed_kernel_w2a8_prelu",
)


@dataclasses.dataclass
class CaseResult:
    case: str
    kernel: str
    valid: bool
    max_err: float
    time_s: float  # best per-call time of the timed batches (measure.min_s)
    flops: int
    eff_flops_per_s: float
    nnz_per_s: float
    frac_roofline: float
    # below DISPATCH_FLOOR_S a call is launch-dominated and frac_roofline
    # misreads as a loss even where the kernel wins on time: compare time_s
    dispatch_bound: bool = False


def _kernels_for_case(x, w_np, b, use_kernels: bool, kernel_filter=None, alpha=ALPHA):
    """(name, fn, args, work_flops, weight_bytes) registry for one case.

    ``x`` and ``b`` are tensors on the case's device and ``w_np`` the dense
    ternary numpy matrix; formats are built on ``x``'s device, and only for
    rows that survive ``kernel_filter`` (their host scans are O(K·N)).
    ``use_kernels`` adds the kernel rows (JAX's ``use_pallas``).
    """

    def wanted(*names):
        return kernel_filter is None or any(n_ in kernel_filter for n_ in names)

    dev = x.device
    w = torch.from_numpy(np.asarray(w_np, np.float32)).to(dev)
    m, k = x.shape
    n = w_np.shape[1]
    nnz = int(np.count_nonzero(w_np))
    dense_f = dense_flops(m, n, k)
    sparse_f = sparse_flops(m, n, nnz)
    dense_bytes = 4 * k * n
    t = (tcsc_from_dense(w_np, device=dev)
         if wanted("tcsc_segsum", "tcsc_segsum_prelu", "tcsc_padded") else None)
    p = pack_ternary(w_np, device=dev) if wanted(*_PACKED_ROWS) else None

    kernels = [
        ("dense", lambda x, w, b: gemm(x, w, b), (x, w, b), dense_f, dense_bytes),
        ("dense_prelu", lambda x, w, b: gemm_prelu(x, w, b, alpha), (x, w, b),
         dense_f + m * n, dense_bytes),
    ]
    if t is not None:
        kernels += [
            ("tcsc_segsum", lambda x, t, b: tcsc_spmm(x, t, b), (x, t, b),
             sparse_f, t.index_bytes()),
            ("tcsc_segsum_prelu", lambda x, t, b: tcsc_spmm_prelu(x, t, b, alpha),
             (x, t, b), sparse_f + m * n, t.index_bytes()),
        ]
    if t is not None and wanted("tcsc_padded"):
        tp = tcsc_pad_columns(t)
        kernels.append(
            ("tcsc_padded", lambda x, tp, b: tcsc_spmm_padded(x, tp, b), (x, tp, b),
             sparse_f, 4 * (tp.cols * (tp.pad_pos + tp.pad_neg + 2))))
    if p is not None:
        kernels.append(("packed_jnp", lambda x, p, b: packed_spmm_ref(x, p, b),
                        (x, p, b), sparse_f, p.weight_bytes()))
        if use_kernels:
            for suffix, cdt in (("", torch.float32), ("_bf16", torch.bfloat16),
                                ("_w2a8", torch.int8)):
                for act in (None, alpha):
                    kernels.append((
                        "packed_kernel" + suffix + ("" if act is None else "_prelu"),
                        lambda x, p, b, a=act, c=cdt: packed_spmm(x, p, b, alpha=a,
                                                                 compute_dtype=c),
                        (x, p, b), sparse_f + (0 if act is None else m * n),
                        p.weight_bytes()))
    if wanted("bcsr") and k % 8 == 0 and n % 8 == 0:
        bm = bcsr_from_dense(w_np, 8, 8, device=dev)
        kernels.append(("bcsr", lambda x, bm, b: bcsr_spmm(x, bm, b), (x, bm, b),
                        sparse_f, bm.value_bytes()))
    if wanted("bcsr_kernel") and use_kernels and k % 128 == 0 and n % 128 == 0:
        # 128x128 blocks, 2-bit codes (B2); on the unstructured showcase
        # matrices every block is stored, so this row measures the block
        # machinery at full occupancy
        prep = bcsr_prepare(bcsr_from_dense(w_np, 128, 128, device=dev), device=dev)
        kernels.append(("bcsr_kernel", lambda x, prep, b: bcsr_spmm_kernel(x, prep, b),
                        (x, prep, b), sparse_f, prep.weight_bytes()))
    if kernel_filter:
        kernels = [k_ for k_ in kernels if k_[0] in kernel_filter]
    return kernels, nnz


def row_tolerance(name: str, oracle) -> float:
    """JAX's per-row tolerance: bf16 rows 1e-2 and W2A8 rows 3e-2 of
    max(1, max|oracle|); every other row TOL_DENSE."""
    scale = max(1.0, float(torch.as_tensor(oracle).abs().max()))
    if "bf16" in name:
        return 0.01 * scale
    if "w2a8" in name:
        return 0.03 * scale
    return TOL_DENSE


def row_ceiling(name: str) -> str:
    """The ``ChipSpec.peak_ops`` key of a row's work: "bf16" for bf16 rows,
    "int8" for W2A8 rows, else "f32_ternary" (f32 X times the ternary W)."""
    if "bf16" in name:
        return "bf16"
    if "w2a8" in name:
        return "int8"
    return "f32_ternary"


def _error(case, name, what, e) -> None:
    print(f"[{case}] {name}: {what} {type(e).__name__}: {str(e)[:120]}",
          file=sys.stderr, flush=True)


def run_case(
    m: int,
    k: int,
    n: int,
    non_zero: int,
    *,
    seed: int = 0,
    iters: int | None = None,
    reps: int = 5,
    validate: bool = True,
    use_kernels: bool | None = None,
    kernel_filter: tuple | None = None,
    alpha: float = ALPHA,
    device=None,
) -> list[CaseResult]:
    """Validate-then-measure every kernel variant on one configuration, on
    ``device`` (None = the CUDA card).

    ``iters`` fixes the calls per timed batch (None calibrates);
    ``use_kernels`` defaults to "the device is CUDA"; ``alpha`` is the
    PReLU slope (the showcase's 0.2; ``run_sweep`` passes the legacy
    sweep's 0.25). On the CPU no row can be timed: each is validated and
    its measurement error printed, with a NaN time.
    """
    dev = resolve_device(device)
    if use_kernels is None:
        use_kernels = dev.type == "cuda"
    gen = rng.make_generator(seed, dev)
    x = rng.rand_dense(gen, (m, k))
    w = rng.rand_ternary(gen, (k, n), non_zero=non_zero)
    b = rng.rand_dense(gen, (n,))
    w_np = w.cpu().numpy()
    kernels, nnz = _kernels_for_case(x, w_np, b, use_kernels, kernel_filter, alpha)

    ref = gemm(x, w, b)
    ref_prelu = gemm_prelu(x, w, b, alpha)
    spec = chip_spec() if dev.type == "cuda" else None
    case = f"{m}x{k}x{n}@{1 / non_zero:.2f}"

    out = []
    for name, fn, args, work, wbytes in kernels:
        oracle = ref_prelu if "prelu" in name else ref
        try:
            tol = row_tolerance(name, oracle)
            cmp = compare(fn(*args), oracle, tol)
        except Exception as e:  # a faulting row must not end the run
            _error(case, name, "ERROR", e)
            out.append(CaseResult(case, name, False, float("inf"), float("nan"),
                                  work, 0.0, 0.0, 0.0))
            continue
        if validate and not cmp.ok:
            out.append(CaseResult(case, name, False, cmp.max_abs_err, float("nan"),
                                  work, 0.0, 0.0, 0.0))
            print(_progress_row(out[-1]), file=sys.stderr, flush=True)
            continue
        try:
            meas = measure(fn, *args, reps=reps, calls=iters)
        except Exception as e:
            _error(case, name, "MEASURE ERROR", e)
            out.append(CaseResult(case, name, True, cmp.max_abs_err, float("nan"),
                                  work, 0.0, 0.0, 0.0))
            continue
        t_best = meas.min_s
        byt = spmm_bytes(m, n, k, weight_bytes=wbytes)
        sol, _ = roofline_bound(2.0 * m * n * k, byt, spec, row_ceiling(name))
        out.append(CaseResult(
            case, name, True, cmp.max_abs_err, t_best, work, work / t_best,
            nnz * m / t_best, sol / t_best, dispatch_bound=t_best < DISPATCH_FLOOR_S,
        ))
        print(_progress_row(out[-1]), file=sys.stderr, flush=True)
    return out


def run_showcase(cases=None, **kw) -> list[CaseResult]:
    """The reference showcase: the fixed case list at 50% density."""
    cases = list(cases or SHOWCASE_CASES)
    prog = Progress(len(cases), label="showcase")
    results = []
    for m, k, n in cases:
        results += run_case(m, k, n, non_zero=2, **kw)
        prog.step()
    return results


def _progress_row(r: CaseResult) -> str:
    return (
        f"[{r.case}] {r.kernel:<24s} "
        + (f"t={r.time_s * 1e6:9.1f}us frac={r.frac_roofline:5.2f} "
           f"err={r.max_err:.1e}" if r.valid else f"INVALID err={r.max_err:.3e}")
    )


def run_sweep(ms=None, ks=None, ns=None, non_zeros=None, **kw) -> list[CaseResult]:
    """The reference sweep's size × sparsity grid (α = 0.25, the legacy
    sweep's slope)."""
    kw.setdefault("alpha", LEGACY_ALPHA)
    grid = list(itertools.product(
        non_zeros or SWEEP_NON_ZERO, ms or SWEEP_M, ks or SWEEP_K, ns or SWEEP_N))
    prog = Progress(len(grid), label="sweep")
    results = []
    for nz, m, k, n in grid:
        results += run_case(m, k, n, non_zero=nz, **kw)
        prog.step()
    return results


def main(argv=None):
    import argparse

    from smmb_tpu_torch.utils.config import BenchConfig

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["showcase", "sweep"], nargs="?", default="showcase")
    ap.add_argument("--config", default=None,
                    help="BenchConfig JSON file; CLI flags override its fields")
    ap.add_argument("--csv", default=None, help="write results CSV here")
    ap.add_argument("--plot", default=None, help="write performance.png here")
    ap.add_argument("--iters", type=int, default=None,
                    help="calls per timed batch (default: calibrated)")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel-name filter (default: all)")
    ap.add_argument("--cases", default=None,
                    help="semicolon-separated MxKxN case filter, e.g. "
                         "'1x1024x4096;64x1024x4096'")
    args = ap.parse_args(argv)

    cfg = BenchConfig()
    if args.config:
        with open(args.config) as f:
            cfg = BenchConfig.from_json(f.read())
    overrides = (
        ("iters", args.iters), ("reps", args.reps), ("seed", args.seed),
        ("kernels", tuple(args.kernels.split(",")) if args.kernels else None),
    )
    cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides if v is not None})
    kw = dict(iters=cfg.iters, reps=cfg.reps, seed=cfg.seed, validate=cfg.validate,
              kernel_filter=cfg.kernels or None)
    if cfg.alpha is not None:  # None = the mode's default (0.2 / 0.25)
        kw["alpha"] = cfg.alpha
    if args.mode == "showcase":
        cases = ([tuple(int(v) for v in c.split("x")) for c in args.cases.split(";")]
                 if args.cases else None)
        results = run_showcase(cases=cases, **kw)
    else:
        results = run_sweep(ms=cfg.ms, ks=cfg.ks, ns=cfg.ns, non_zeros=cfg.non_zeros, **kw)
    rows = [dataclasses.asdict(r) for r in results]
    print(results_table(rows, [
        "case", "kernel", "valid", "max_err", "time_s",
        "eff_flops_per_s", "nnz_per_s", "frac_roofline",
    ]))
    for case in dict.fromkeys(r.case for r in results):
        sub = [dataclasses.asdict(r) for r in results if r.case == case]
        print(f"\n[{case}] " + speedup_analysis(sub))
    if args.csv:
        to_csv(rows, args.csv)
        # the resolved config beside the artifact reproduces the CSV
        with open(args.csv + ".config.json", "w") as f:
            f.write(cfg.to_json())
        print(f"\nwrote {args.csv} (+ .config.json)")
    if args.plot:
        from smmb_tpu_torch.bench.report import plot_performance

        out = plot_performance(rows, args.plot)
        print(f"wrote {out}")
    bad = [r for r in results if not r.valid]
    if bad:
        print(f"{len(bad)} INVALID rows", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
