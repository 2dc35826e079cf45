#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (smmb_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each of
which exits non-zero on failure:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the path from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, in every
   mode, at the test shapes and the headline shapes, with and without bias
   and PReLU, and the launch counter rising once per call;
4. the main path at full width: the packed ternary MLP of
   ``python -m smmb_tpu_torch mlp`` (depth 4, dim 4096, batch 256, density
   1/10, bf16) with exactly one kernel launch per layer, and the MLP of
   ``__graft_entry__.entry()`` ((1024, 2048, 2048, 1024), batch 64, f32),
   each against the plain path;
5. times through ``bench/measure.py`` (CUDA events): per mode at the
   headline shape the kernel, its bound, the plain version and one PyTorch
   library call on the same inputs; the full-width MLP forward.

The line before the last is the card's name and power limit, the line
before that the per-kernel JSON summary, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 1 and
prints no result.
"""

import json
import subprocess
import sys
import time

T0 = time.time()
ALPHA = 0.2


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    check(torch.cuda.is_available(), "no CUDA device: the port runs on the card")
    from smmb_tpu_torch.bench.flops import sparse_flops, spmm_bytes
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.mlp_bench import build_mlp, run_mlp_bench
    from smmb_tpu_torch.bench.roofline import chip_spec, roofline_bound
    from smmb_tpu_torch.formats.packed import pack_ternary_device, unpack_ternary
    from smmb_tpu_torch.kernels import _build
    from smmb_tpu_torch.kernels.packed_spmm import (
        packed_spmm,
        packed_spmm_plain,
        quantize_rows,
    )
    from smmb_tpu_torch.models.mlp import (
        TernaryMLPConfig,
        init_mlp,
        mlp_forward,
        pack_mlp,
    )
    from smmb_tpu_torch.utils import rng

    # ---------------------------------------------------------------- 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    spec = chip_spec()
    log(f"roofline spec: {spec}")
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 2
    t = time.time()
    build_logs = _build.build_all()
    log(f"built {sorted(build_logs) or 'nothing (up to date)'} "
        f"in {time.time() - t:.1f}s")
    for src, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "Function properties" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")

    # ---------------------------------------------------------------- 3
    # tolerances, each relative to max(1, max|Y|):
    #  f32  1e-4: f32 sums in another order than the cuBLAS f32 product;
    #  bf16 2**-7: X and Y in bf16; the f32 sums agree to ~1e-6, so
    #       rounding Y to bf16 differs by at most one bf16 ulp (2**-7 rel);
    #  int8 1e-6: same int8 codes and exact integer sums on both sides and
    #       the same separately rounded dequant and bias (f32 output).
    modes = {  # name: (compute dtype, x dtype, tolerance)
        "f32": (torch.float32, torch.float32, 1e-4),
        "bf16": (torch.bfloat16, torch.bfloat16, 2.0 ** -7),
        "int8": (torch.int8, torch.float32, 1e-6),
    }
    # the test shapes, the headline shapes and the entry() MLP's layers
    shapes = [(1, 512, 1024), (16, 512, 512), (8, 1024, 640), (100, 512, 512),
              (4, 100, 256), (8, 2048, 256), (1, 4096, 4096), (256, 4096, 4096),
              (64, 1024, 2048), (64, 2048, 2048), (64, 2048, 1024)]
    gen = rng.make_generator(1234, dev)
    n_checked = 0
    for (m, k, n) in shapes:
        non_zero = 10 if k == 4096 else 2
        w = rng.rand_ternary(gen, (k, n), non_zero=non_zero)
        p = pack_ternary_device(w)
        check(torch.equal(unpack_ternary(p), w), f"pack round trip {k}x{n}")
        b = rng.rand_dense(gen, (n,))
        for name, (cdt, xdt, tol) in modes.items():
            x = rng.rand_dense(gen, (m, k), dtype=xdt)
            for bias, alpha in ((b, ALPHA), (None, None)):
                before = packed_spmm.launches
                y = packed_spmm(x, p, bias, alpha, compute_dtype=cdt)
                check(packed_spmm.launches == before + 1,
                      f"launch count {name} {m}x{k}x{n}")
                ref = packed_spmm_plain(x, p, bias, alpha, compute_dtype=cdt)
                torch.cuda.synchronize()
                check(y.shape == (m, n) and y.dtype == xdt, f"shape/dtype {name}")
                check(bool(torch.isfinite(y).all()), f"non-finite {name} {m}x{k}x{n}")
                err = float((y.float() - ref.float()).abs().max())
                lim = tol * max(1.0, float(ref.float().abs().max()))
                check(err <= lim, f"kernel vs plain {name} {m}x{k}x{n} "
                      f"bias={bias is not None}: err {err:.3e} > {lim:.3e}")
                n_checked += 1
        log(f"kernel == plain at {m}x{k}x{n} in f32, bf16, int8")
    x3 = rng.rand_dense(gen, (3, 4, 512))
    p3 = pack_ternary_device(rng.rand_ternary(gen, (512, 256)))
    y3 = packed_spmm(x3, p3, None, ALPHA)
    ref3 = packed_spmm_plain(x3.reshape(12, 512), p3, None, ALPHA).reshape(3, 4, 256)
    check(y3.shape == (3, 4, 256), "3-D x keeps its leading dims")
    check(float((y3 - ref3).abs().max()) <= 1e-4 * max(1.0, float(ref3.abs().max())),
          "3-D x kernel vs plain")
    log(f"phase 3 passed: {n_checked + 1} kernel calls checked against plain")

    # ---------------------------------------------------------------- 4
    cfg, packed, x, _ = build_mlp(4, 4096, 256, 10, dev)
    torch.cuda.synchronize()
    packed_spmm.launches = 0
    y = mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    main_launches = packed_spmm.launches
    check(main_launches == cfg.num_layers,
          f"main path launched packed_spmm {main_launches} times, "
          f"expected {cfg.num_layers}")
    y_ref = mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16, use_kernel=False)
    torch.cuda.synchronize()
    check(y.shape == (256, 4096) and bool(torch.isfinite(y).all()),
          "full-width MLP output shape / finiteness")
    # each layer re-rounds its input to bf16; sums that differ in order by
    # ~1e-6 can flip that rounding by one bf16 ulp (2**-8 relative)
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    check(err <= 1e-2 * scale, f"full-width MLP kernel vs plain: {err:.3e} "
          f"vs max|Y| {scale:.3e}")
    log(f"main path (depth 4 x 4096, batch 256, bf16): launches {main_launches}, "
        f"max err {err:.3e} of max|Y| {scale:.3e}")

    ecfg = TernaryMLPConfig(layer_dims=(1024, 2048, 2048, 1024))
    egen = rng.make_generator(1, dev)
    epacked = pack_mlp(init_mlp(egen, ecfg))
    ex = rng.rand_dense(egen, (64, 1024))
    torch.cuda.synchronize()
    packed_spmm.launches = 0
    ey = mlp_forward(epacked, ex, ecfg)
    torch.cuda.synchronize()
    entry_launches = packed_spmm.launches
    check(entry_launches == ecfg.num_layers, f"entry MLP launches {entry_launches}")
    ey_ref = mlp_forward(epacked, ex, ecfg, use_kernel=False)
    torch.cuda.synchronize()
    eerr = float((ey - ey_ref).abs().max())
    escale = float(ey_ref.abs().max())
    check(ey.shape == (64, 1024) and bool(torch.isfinite(ey).all()), "entry MLP shape")
    check(eerr <= 1e-5 * max(1.0, escale), f"entry MLP f32 kernel vs plain: "
          f"{eerr:.3e} vs max|Y| {escale:.3e}")
    log(f"entry() MLP (1024,2048,2048,1024), batch 64, f32: launches "
        f"{entry_launches}, max err {eerr:.3e} of max|Y| {escale:.3e}")

    # ---------------------------------------------------------------- 5
    m, k, n = 256, 4096, 4096
    hgen = rng.make_generator(0, dev)
    hx = rng.rand_dense(hgen, (m, k))
    hw = rng.rand_ternary(hgen, (k, n), non_zero=10)
    hb = rng.rand_dense(hgen, (n,))
    nnz = int(torch.count_nonzero(hw))
    hp = pack_ternary_device(hw, nnz=nnz)
    n_bytes = spmm_bytes(m, n, k, weight_bytes=hp.weight_bytes())
    torch.backends.cuda.matmul.allow_tf32 = False
    hw_dense = unpack_ternary(hp)
    library = {
        "f32": (torch.matmul, (hx, hw_dense)),
        "bf16": (torch.matmul, (hx.to(torch.bfloat16), hw_dense.to(torch.bfloat16))),
        "int8": (torch._int_mm, (quantize_rows(hx)[0], hw_dense.to(torch.int8))),
    }
    per_mode = {}
    for name, (cdt, _, tol) in modes.items():
        y = packed_spmm(hx, hp, hb, ALPHA, compute_dtype=cdt)
        ref = packed_spmm_plain(hx, hp, hb, ALPHA, compute_dtype=cdt)
        torch.cuda.synchronize()
        max_err = float((y - ref).abs().max())
        t_kernel = measure(lambda: packed_spmm(hx, hp, hb, ALPHA, compute_dtype=cdt))
        t_plain = measure(lambda: packed_spmm_plain(hx, hp, hb, ALPHA, compute_dtype=cdt))
        lib_fn, lib_args = library[name]
        t_lib = measure(lib_fn, *lib_args)
        bound_s, bound_by = roofline_bound(sparse_flops(m, n, nnz), n_bytes, spec, name)
        dense_s, dense_by = roofline_bound(2.0 * m * n * k, n_bytes, spec, name)
        per_mode[name] = {
            "mode": name, "shape": [m, k, n], "nnz": nnz, "max_abs_err": max_err,
            "ms": t_kernel.min_s * 1e3, "mean_ms": t_kernel.mean_s * 1e3,
            "std_ms": t_kernel.std_s * 1e3, "plain_ms": t_plain.min_s * 1e3,
            "library_ms": t_lib.min_s * 1e3, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "dense_bound_ms": dense_s * 1e3,
            "dense_bound_by": dense_by,
        }
        print(json.dumps(per_mode[name]), flush=True)

    x1 = rng.rand_dense(hgen, (1, k))
    t1 = measure(lambda: packed_spmm(x1, hp, hb, ALPHA, compute_dtype=torch.bfloat16))
    t1_plain = measure(
        lambda: packed_spmm_plain(x1, hp, hb, ALPHA, compute_dtype=torch.bfloat16))
    b1, b1_by = roofline_bound(sparse_flops(1, n, nnz),
                               spmm_bytes(1, n, k, weight_bytes=hp.weight_bytes()),
                               spec, "bf16")
    print(json.dumps({"mode": "bf16", "shape": [1, k, n], "ms": t1.min_s * 1e3,
                      "plain_ms": t1_plain.min_s * 1e3, "bound_ms": b1 * 1e3,
                      "bound_by": b1_by}), flush=True)

    for use_kernel in (True, False):
        r = run_mlp_bench(4, 4096, 256, 10, use_kernel=use_kernel, device=dev)
        print(json.dumps({
            "mlp": r.label, "depth": 4, "dim": 4096, "batch": 256,
            "compute": "bf16", "ms": r.min_s * 1e3, "mean_ms": r.mean_s * 1e3,
            "rows_per_s": r.rows_per_s, "nnz_per_s": r.nnz_per_s,
            "bound_ms": r.bound_s * 1e3, "bound_by": r.bound_by,
            "frac_roofline": r.frac_roofline,
        }), flush=True)

    main_mode = per_mode["bf16"]  # the main path's mode and per-layer shape
    summary = {"kernels": [{
        "name": "packed_spmm",
        "route": "cuda",
        "source": "smmb_tpu_torch/kernels/csrc/packed_spmm.cu",
        "replaces": "smmb_tpu/kernels/packed_spmm.py:388",
        "launches": main_launches,
        "max_abs_err": main_mode["max_abs_err"],
        "ms": main_mode["ms"],
        "plain_ms": main_mode["plain_ms"],
        "bound_ms": main_mode["bound_ms"],
        "bound_by": main_mode["bound_by"],
        "library_ms": main_mode["library_ms"],
    }]}
    log(f"all phases passed in {time.time() - T0:.1f}s")
    print(json.dumps(summary), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
