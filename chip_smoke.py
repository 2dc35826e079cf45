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
   library call on the same inputs; the full-width MLP forward;
6. the fused LM kernels (B3 fused_norm_qkv, B5 fused_block_tail, B6
   fused_mlp) against their plain versions in f32 and bf16 compute at the
   shapes of the LM path (and B3 at a GQA width, N = 1536), each call
   raising its launch count by one;
7. row identity: row 0 of an M = 8 call equals the M = 1 call bitwise
   (B3, B5, B6);
8. the LM main path: ``generate`` at the default configuration of
   ``python -m smmb_tpu_torch lm`` (4 layers, d_model 1024, 8 heads, d_ff
   4096, vocab 8192, batch 1, 32-token prompt, 64 greedy steps, bf16) with
   the launch counts of every kernel, its per-step logits (bf16 and f32)
   held against the plain path (the kernels' plain versions in their place)
   teacher-forced on its tokens, and µs/token from ``bench/lm_bench.py``;
9. times of B3, B5 and B6 at the path's shapes: kernel, plain version,
   bound, and ``torch.matmul`` on the pre-decoded dense bf16 weights;
10. B4 (flash decode / chunk) against its plain version in f32 and bf16 at
    the LM path's shapes, the decode bench's, GQA, a window and B = 4, each
    call raising its launch count by one; chunk row c equals the decode
    step at pos + c and row r of a B = 4 call the row served alone, bitwise;
11. B9 (flash prefill) against its plain version in f32 and bf16: the LM
    prefill, T = 512 causal, T = 200, GQA, a window, non-causal, hd = 64;
12. the flash LM path: ``generate(use_flash=True)`` at the ``lm`` defaults
    with every kernel's launch count, its teacher-forced logits against the
    plain path, ``lm_prefill_chunked`` against ``lm_prefill``,
    ``block_extend`` (C = 4) bitwise per row against four decode steps,
    µs/token and the decode bench with and without flash, and the
    ``bench/trace.py --lm`` step with and without flash;
13. times of B4 and B9 at the path shapes and at one long shape each:
    kernel, plain version, bound, and ``scaled_dot_product_attention``.

The line before the last is the card's name and power limit, the line
before that the per-kernel JSON summary, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 1 and
prints no result.
"""

import contextlib
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

    fused = check_fused_kernels(torch, dev)
    lm = run_lm_path(torch, dev)
    fused_rows = time_fused_kernels(torch, dev, spec, fused, lm)
    flash_err = check_flash_kernels(torch, dev)
    flash = run_flash_lm_path(torch, dev, lm)
    flash_rows = time_flash_kernels(torch, dev, spec, flash_err, flash)

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
    }, *fused_rows, *flash_rows]}
    log(f"all phases passed in {time.time() - T0:.1f}s")
    print(json.dumps(summary), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# ------------------------------------------------------------ LM slice
def _tern(gen, shape):
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.utils import rng

    return pack_ternary_device(rng.rand_ternary(gen, shape, non_zero=2))


def _fused_inputs(torch, gen, name, m, d, n_or_h, dev, x_dtype=None):
    """Random inputs of one fused kernel at d (K, A, D) and n_or_h (N or H)."""
    from smmb_tpu_torch.utils import rng

    f32 = torch.float32
    sc = lambda v: torch.tensor(v, dtype=f32, device=dev)  # noqa: E731
    xd = x_dtype or f32
    if name == "fused_norm_qkv":
        n = n_or_h
        return (rng.rand_dense(gen, (m, d), dtype=xd),
                1.0 + 0.1 * rng.rand_dense(gen, (d,)), _tern(gen, (d, n)),
                0.5 + rng.rand_dense(gen, (n,)).abs(), rng.rand_dense(gen, (n,)))
    h = n_or_h
    if name == "fused_mlp":
        return (rng.rand_dense(gen, (m, d), dtype=xd), _tern(gen, (d, h)),
                sc(0.37), rng.rand_dense(gen, (h,)), _tern(gen, (h, d)),
                sc(1.21), rng.rand_dense(gen, (d,)))
    return (rng.rand_dense(gen, (m, d), dtype=x_dtype or torch.bfloat16),
            rng.rand_dense(gen, (m, d)), _tern(gen, (d, d)), sc(0.9),
            rng.rand_dense(gen, (d,)), 1.0 + 0.1 * rng.rand_dense(gen, (d,)),
            _tern(gen, (d, h)), sc(0.37), rng.rand_dense(gen, (h,)),
            _tern(gen, (h, d)), sc(1.21), rng.rand_dense(gen, (d,)))


def _fused_kwargs(name, cdt):
    if name == "fused_norm_qkv":
        return dict(eps=1e-6, compute_dtype=cdt)
    if name == "fused_mlp":
        return dict(alpha=ALPHA, compute_dtype=cdt)
    return dict(alpha=ALPHA, eps=1e-6, compute_dtype=cdt)


def _rows(args, name, r0, r1):
    """The inputs restricted to rows [r0, r1) (activations only)."""
    n_act = 2 if name == "fused_block_tail" else 1
    return tuple(a[r0:r1] if i < n_act else a for i, a in enumerate(args))


# the LM path's shapes: B3 at M=1 (and the GQA width), B5 at M=1, B6 at M=32
FUSED_SHAPES = [
    ("fused_norm_qkv", 1, 1024, 3072), ("fused_norm_qkv", 1, 1024, 1536),
    ("fused_norm_qkv", 8, 1024, 3072), ("fused_block_tail", 1, 1024, 4096),
    ("fused_block_tail", 8, 1024, 4096), ("fused_mlp", 32, 1024, 4096),
    ("fused_mlp", 1, 1024, 4096), ("fused_mlp", 3, 512, 1024),
]


def check_fused_kernels(torch, dev) -> dict:
    """Phases 6 and 7. Returns {name: max abs err at the path shape, bf16}."""
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.utils import rng

    # tolerances, relative to max(1, max|Y|): f32 1e-4 (f32 sums in another
    # order than the plain version's exact product); bf16 2**-7 (a sum that
    # differs by an f32 ulp can round a staged value to the next bf16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
    gen = rng.make_generator(77, dev)
    path_err = {}
    for name, m, d, n_or_h in FUSED_SHAPES:
        fn, plain = getattr(fk, name), getattr(fk, name + "_plain")
        args = _fused_inputs(torch, gen, name, m, d, n_or_h, dev)
        for cdt in (torch.float32, torch.bfloat16):
            kw = _fused_kwargs(name, cdt)
            before = fn.launches
            y = fn(*args, **kw)
            check(fn.launches == before + 1, f"{name} launch count")
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            check(y.shape == ref.shape and y.dtype == ref.dtype, f"{name} shape/dtype")
            check(bool(torch.isfinite(y).all()), f"{name} non-finite {m}x{d}x{n_or_h}")
            err = float((y.float() - ref.float()).abs().max())
            lim = tol[cdt] * max(1.0, float(ref.float().abs().max()))
            check(err <= lim, f"{name} kernel vs plain {cdt} {m}x{d}x{n_or_h}: "
                  f"err {err:.3e} > {lim:.3e}")
            if cdt == torch.bfloat16 and (m, d, n_or_h) == _path_shape(name):
                path_err[name] = err
        log(f"{name} == plain at M={m}, {d}x{n_or_h} in f32 and bf16")
    # bf16 x in, bf16 out
    args = _fused_inputs(torch, gen, "fused_mlp", 4, 1024, 2048, dev, torch.bfloat16)
    y = fk.fused_mlp(*args, **_fused_kwargs("fused_mlp", torch.bfloat16))
    ref = fk.fused_mlp_plain(*args, **_fused_kwargs("fused_mlp", torch.bfloat16))
    torch.cuda.synchronize()
    check(y.dtype == torch.bfloat16, "bf16 x gives a bf16 result")
    check(float((y.float() - ref.float()).abs().max())
          <= 2.0 ** -7 * max(1.0, float(ref.float().abs().max())), "bf16 in/out fused_mlp")
    log("phase 6 passed: B3, B5, B6 agree with their plain versions")

    for name in ("fused_norm_qkv", "fused_block_tail", "fused_mlp"):
        _, _, d, n_or_h = next(s for s in FUSED_SHAPES if s[0] == name)
        fn = getattr(fk, name)
        args = _fused_inputs(torch, gen, name, 8, d, n_or_h, dev)
        for cdt in (torch.float32, torch.bfloat16):
            kw = _fused_kwargs(name, cdt)
            chunk = fn(*args, **kw)
            row = fn(*_rows(args, name, 0, 1), **kw)
            torch.cuda.synchronize()
            check(torch.equal(chunk[:1], row), f"{name} row 0 of M=8 != M=1 ({cdt})")
    log("phase 7 passed: row 0 of an M=8 call equals the M=1 call bitwise")
    return path_err


def _path_shape(name):
    return {"fused_norm_qkv": (1, 1024, 3072), "fused_block_tail": (1, 1024, 4096),
            "fused_mlp": (32, 1024, 4096)}[name]


def run_lm_path(torch, dev) -> dict:
    """Phase 8: ``generate`` at the default ``lm`` configuration."""
    from smmb_tpu_torch.bench.lm_bench import build_lm, run_lm_bench
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import TernaryLMConfig, generate

    layers, prompt_len, steps = 4, 32, 64
    cfg = TernaryLMConfig(vocab=8192, d_model=1024, n_heads=8, d_ff=4096,
                          n_layers=layers, max_len=prompt_len + 3 * steps)
    packed, prompt = build_lm(cfg, 1, prompt_len, device=dev)
    bf16 = torch.bfloat16
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    toks = generate(packed, prompt, cfg, steps, compute_dtype=bf16)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"generate: launches {launches}")
    check(toks.shape == (1, steps) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, "generate tokens shape / range")
    check(launches["fused_mlp"] == layers, "B6 launches once per layer in the prefill")
    check(launches["fused_norm_qkv"] == layers * steps, "B3 once per layer per step")
    check(launches["fused_block_tail"] == layers * steps, "B5 once per layer per step")
    # B1: 6 projections per layer in the prefill (k, v for the cache, then
    # q, k, v, o of the forward, as in JAX) + the head once in the prefill
    # and once per step
    b1 = 6 * layers + 1 + steps
    check(launches["packed_spmm"] == b1, f"B1 launches {launches['packed_spmm']} != {b1}")

    # per-step logits, teacher-forced on the kernel path's tokens, against
    # the plain path: the same entry points on the card with each kernel's
    # plain version in its place. This random model's attention scores are
    # in the hundreds, so one ulp of a staged value can move a step's logits
    # by more than one rounding would; the unfused path through plain
    # products (use_kernel=False) measures that spread, and the kernel path
    # may be no farther from the plain path than that spread or the
    # tolerance, with its median step within the tolerance.
    for cdt, tol in ((bf16, 2.0 ** -7), (torch.float32, 1e-4)):
        ids = toks if cdt == bf16 else generate(packed, prompt, cfg, steps,
                                                compute_dtype=cdt)
        kern = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True)
        with plain_kernels():
            plain = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True)
        unfused = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, False)
        check(bool(torch.isfinite(kern).all()), "LM logits finite")
        check(torch.equal(kern.argmax(-1), ids[0]),
              "teacher-forced kernel path reproduces generate's tokens")
        scale = plain.abs().amax(-1).clamp_min(1.0)
        err = (kern - plain).abs().amax(-1) / scale
        spread = (unfused - plain).abs().amax(-1) / scale
        med, worst = float(err.median()), float(err.max())
        check(med <= tol, f"LM {cdt}: median step error {med:.3e} > {tol:.3e}")
        check(worst <= max(tol, float(spread.max())),
              f"LM {cdt}: worst step error {worst:.3e} beyond the tolerance "
              f"{tol:.3e} and the plain orders' spread {float(spread.max()):.3e}")
        top2 = torch.topk(plain, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / scale
        differs = plain.argmax(-1) != ids[0]
        check(not bool((differs & (gap > tol)).any()),
              f"LM {cdt}: a token differs where the plain top-2 gap exceeds {tol:.1e}")
        log(f"LM {cdt} logits vs plain over {steps} steps: median {med:.2e}, worst "
            f"{worst:.2e} (plain orders' spread {float(spread.max()):.2e}, tolerance "
            f"{tol:.1e}); {int(differs.sum())} near-tied tokens differ")
    r = run_lm_bench(cfg, 1, prompt_len, steps, reps=3, device=dev)
    rp = _plain_lm_tokens_time(torch, cfg, packed, prompt, steps)
    print(json.dumps({"lm": "generate", "layers": layers, "d_model": 1024,
                      "d_ff": 4096, "vocab": 8192, "prompt": prompt_len,
                      "steps": steps, "us_per_token": r.per_token_s * 1e6,
                      "tok_per_s": r.tokens_per_s, "lo_ms": r.lo_s * 1e3,
                      "hi_ms": r.hi_s * 1e3, "plain_us_per_token": rp * 1e6,
                      "launches": launches}), flush=True)
    log(f"phase 8 passed: {r.per_token_s * 1e6:.1f} us/token, "
        f"{r.tokens_per_s:.0f} tok/s (plain path {rp * 1e6:.1f} us/token)")
    return {"launches": launches, "cfg": cfg, "packed": packed, "prompt": prompt}


def _teacher_forced(torch, cfg, packed, prompt, ids, cdt, use_kernel, use_flash=False):
    """(steps, vocab) f32 logits of lm_prefill then lm_decode_step on ``ids``."""
    from smmb_tpu_torch.models.lm import lm_decode_step, lm_init_cache, lm_prefill

    kw = dict(compute_dtype=cdt, use_kernel=use_kernel, use_flash=use_flash)
    cache = lm_init_cache(cfg, prompt.shape[0], dtype=cdt, device=prompt.device)
    logits, cache = lm_prefill(packed, prompt, cache, cfg, **kw)
    out = [logits]
    for i in range(ids.shape[1] - 1):
        logits, cache = lm_decode_step(packed, ids[:, i], cache, cfg, **kw)
        out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out, 1)[0].float()


@contextlib.contextmanager
def plain_kernels():
    """The LM path's kernels replaced by their plain versions, for the
    reference runs of phases 8 and 12 (the wrappers themselves launch on any
    CUDA tensor); the launch counts do not move."""
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm_plain
    from smmb_tpu_torch.models import attention, lm, transformer

    def plain_of(fn):
        return lambda *a, block_h=None, block_n=None, **k: fn(*a, **k)

    swaps = [(fk, n, plain_of(getattr(fk, n + "_plain")))
             for n in ("fused_norm_qkv", "fused_block_tail", "fused_mlp")]
    swaps += [(fd, n, getattr(fd, n + "_plain"))
              for n in ("flash_attention_decode", "flash_attention_chunk")]
    swaps += [(fa, "flash_attention", fa.flash_attention_plain)]
    swaps += [(m, "packed_spmm", packed_spmm_plain) for m in (attention, transformer, lm)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _plain_lm_tokens_time(torch, cfg, packed, prompt, steps) -> float:
    """µs/token slope of ``generate(use_kernel=False)`` on the card (the
    unfused path through the plain PyTorch products), as lm_bench times the
    kernel path."""
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.models.lm import generate

    def timed(n):
        return measure(lambda: generate(packed, prompt, cfg, n,
                                        compute_dtype=torch.bfloat16,
                                        use_kernel=False), reps=3).min_s

    return (timed(3 * steps) - timed(steps)) / (2 * steps)


def time_fused_kernels(torch, dev, spec, path_err, lm) -> list:
    """Phase 9: each fused kernel at the path's shape, bf16 compute."""
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.roofline import roofline_bound
    from smmb_tpu_torch.formats.packed import unpack_ternary
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.utils import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = rng.make_generator(5, dev)
    sources = {"fused_norm_qkv": ":332", "fused_block_tail": ":707", "fused_mlp": ":195"}
    per_launch = {"fused_norm_qkv": "per decode step (4 layers)",
                  "fused_block_tail": "per decode step (4 layers)",
                  "fused_mlp": "per 32-token prefill (4 layers)"}
    rows = []
    for name in ("fused_norm_qkv", "fused_block_tail", "fused_mlp"):
        m, d, n_or_h = _path_shape(name)
        args = _fused_inputs(torch, gen, name, m, d, n_or_h, dev)
        kw = _fused_kwargs(name, torch.bfloat16)
        fn, plain = getattr(fk, name), getattr(fk, name + "_plain")
        t_kernel = measure(lambda: fn(*args, **kw))
        t_plain = measure(lambda: plain(*args, **kw))
        planes = [a for a in args if hasattr(a, "weight_bytes")]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        out = fn(*args, **kw)
        n_bytes = (sum(p.weight_bytes() for p in planes)
                   + sum(t.numel() * t.element_size() for t in tensors)
                   + out.numel() * out.element_size())
        nnz = [int(torch.count_nonzero(unpack_ternary(p))) for p in planes]
        ops = 2.0 * m * sum(nnz)  # the ±1 entries this data holds, per row
        bound_s, bound_by = roofline_bound(ops, n_bytes, spec, "bf16")
        # library yardstick: torch.matmul on the pre-decoded dense bf16
        # weights, one call per product of the kernel, times summed
        dense = [unpack_ternary(p, torch.bfloat16) for p in planes]
        t_lib = 0.0
        for w in dense:
            a = rng.rand_dense(gen, (m, w.shape[0]), dtype=torch.bfloat16)
            t_lib += measure(torch.matmul, a, w).min_s
        row = {
            "name": name, "route": "cuda",
            "source": "smmb_tpu_torch/kernels/csrc/fused_mlp.cu",
            "replaces": "smmb_tpu/kernels/fused_mlp.py" + sources[name],
            "launches": lm["launches"][name], "max_abs_err": path_err[name],
            "ms": t_kernel.min_s * 1e3, "plain_ms": t_plain.min_s * 1e3,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": t_lib * 1e3,
        }
        print(json.dumps({**row, "shape": [m, d, n_or_h], "bytes": n_bytes,
                          "ops": ops, "mean_ms": t_kernel.mean_s * 1e3,
                          "launches_are": per_launch[name],
                          "library": f"torch.matmul bf16 on pre-decoded dense W, "
                                     f"sum of {len(dense)} products"}), flush=True)
        rows.append(row)
    log("phase 9 passed: fused kernels timed at the path shapes")
    return rows


# ---------------------------------------------------------- flash slice
# B4 at the shapes of the paths: (label, B, H, KVH, S, pos, window); hd 128
FLASH_DECODE_SHAPES = [
    ("lm path", 1, 8, 8, 224, 32, None), ("lm path", 1, 8, 8, 224, 95, None),
    ("decode bench", 1, 8, 8, 1024, 512, None), ("GQA 8/2", 1, 8, 2, 1024, 512, None),
    ("window 64", 1, 8, 8, 1024, 512, 64), ("B=4", 4, 8, 8, 1024, 512, None),
]
# B9: (label, B, H, KVH, T, hd, causal, window); hd 256 and 512 take the
# kernel's 32- and 16-row tiles
FLASH_PREFILL_SHAPES = [
    ("lm prefill", 1, 8, 8, 32, 128, True, None),
    ("T=512 causal", 1, 8, 8, 512, 128, True, None),
    ("T=200", 1, 8, 8, 200, 128, True, None), ("GQA 8/2", 1, 8, 2, 512, 128, True, None),
    ("window 64", 1, 8, 8, 512, 128, True, 64),
    ("non-causal", 1, 8, 8, 256, 128, False, None), ("hd=64", 1, 8, 8, 256, 64, True, None),
    ("hd=256", 1, 4, 4, 200, 256, True, None), ("hd=512", 1, 2, 2, 100, 512, True, None),
]


def _held(torch, name, y, ref, tol, what) -> float:
    """Max abs error of a kernel's result against its plain version, checked
    against ``tol`` relative to max(1, max|ref|)."""
    torch.cuda.synchronize()
    check(y.shape == ref.shape and y.dtype == ref.dtype, f"{name} shape/dtype {what}")
    check(bool(torch.isfinite(y).all()), f"{name} non-finite {what}")
    err = float((y.float() - ref.float()).abs().max())
    lim = tol * max(1.0, float(ref.float().abs().max()))
    check(err <= lim, f"{name} kernel vs plain {what}: err {err:.3e} > {lim:.3e}")
    return err


def _decode_inputs(torch, gen, b, nq, h, kvh, s, cache_dtype):
    """q (B, nq, H, 128) f32 (as B3 gives it, scaled so that the softmax
    has peaks) and random flat (B, S, KVH·128) caches."""
    from smmb_tpu_torch.utils import rng

    q = rng.rand_dense(gen, (b, nq, h, 128)) * 8.0
    kc = rng.rand_dense(gen, (b, s, kvh * 128), dtype=cache_dtype)
    vc = rng.rand_dense(gen, (b, s, kvh * 128), dtype=cache_dtype)
    return q, kc, vc


def check_flash_kernels(torch, dev) -> dict:
    """Phases 10 and 11. Returns the max abs errors at the path shapes."""
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.utils import rng

    # tolerances, relative to max(1, max|Y|): f32 1e-4 (f32 sums in another
    # order than the plain version's exact products, exp2 within 2 ulp);
    # bf16 2**-7 (a p or an output can round to the neighbouring bf16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
    gen = rng.make_generator(91, dev)
    dec = fd.flash_attention_decode
    errs = {}
    for label, b, h, kvh, s, pos, window in FLASH_DECODE_SHAPES:
        for cdt in (torch.float32, torch.bfloat16):
            q, kc, vc = _decode_inputs(torch, gen, b, 5, h, kvh, s, cdt)
            kw = dict(window=window, compute_dtype=cdt)
            what = f"{label} pos {pos} {cdt}"
            before = dec.launches
            y = dec(q[:, 0], kc, vc, pos, **kw)
            check(dec.launches == before + 1, f"B4 launch count {what}")
            err = _held(torch, "B4", y, fd.flash_attention_decode_plain(
                q[:, 0], kc, vc, pos, **kw), tol[cdt], what)
            if (label, pos, cdt) == ("lm path", 95, torch.bfloat16):
                errs["flash_attention_decode"] = err
            # chunk rows pos-4 .. pos against the decode steps, bitwise
            chunk = fd.flash_attention_chunk(q, kc, vc, pos - 4, **kw)
            check(dec.launches == before + 2, f"B4 chunk launch count {what}")
            _held(torch, "B4 chunk", chunk, fd.flash_attention_chunk_plain(
                q, kc, vc, pos - 4, **kw), tol[cdt], what)
            for c in range(5):
                solo = dec(q[:, c], kc, vc, pos - 4 + c, **kw)
                check(torch.equal(chunk[:, c], solo), f"B4 chunk row {c} != decode {what}")
            for r in range(b if b > 1 else 0):
                row = dec(q[r:r + 1, 0], kc[r:r + 1], vc[r:r + 1], pos, **kw)
                check(torch.equal(y[r:r + 1], row), f"B4 batch row {r} != alone {what}")
        log(f"B4 == plain at {label}, B={b} H={h} KVH={kvh} S={s} pos={pos} "
            f"window={window} in f32 and bf16; chunk and batch rows bitwise")
    log("phase 10 passed: B4 agrees with its plain version, rows bitwise")

    for label, b, h, kvh, t, hd, causal, window in FLASH_PREFILL_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            q = (rng.rand_dense(gen, (b, t, h, hd)) * 4.0).to(dt).permute(0, 2, 1, 3)
            k = rng.rand_dense(gen, (b, kvh, t, hd), dtype=dt)
            v = rng.rand_dense(gen, (b, kvh, t, hd), dtype=dt)
            kw = dict(causal=causal, window=window)
            before = fa.flash_attention.launches
            y = fa.flash_attention(q, k, v, **kw)
            check(fa.flash_attention.launches == before + 1, f"B9 launch count {label}")
            err = _held(torch, "B9", y, fa.flash_attention_plain(q, k, v, **kw), tol[dt],
                        f"{label} {dt}")
            if (label, dt) == ("lm prefill", torch.float32):
                errs["flash_attention"] = err
        log(f"B9 == plain at {label} (B={b} H={h} KVH={kvh} T={t} hd={hd} "
            f"causal={causal} window={window}) in f32 and bf16")
    log("phase 11 passed: B9 agrees with its plain version")
    return errs


def run_flash_lm_path(torch, dev, lm) -> dict:
    """Phase 12: the flash LM path at the ``lm`` defaults."""
    from smmb_tpu_torch.bench.decode_bench import run_decode_bench
    from smmb_tpu_torch.bench.lm_bench import parser, run_lm_bench
    from smmb_tpu_torch.bench.trace import lm_decode_step_fn, report
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import (
        generate,
        lm_init_cache,
        lm_prefill,
        lm_prefill_chunked,
    )
    from smmb_tpu_torch.models.transformer import (
        block_decode_step,
        block_extend,
        block_prefill,
        init_block_cache,
    )
    from smmb_tpu_torch.utils import rng

    cfg, packed, prompt = lm["cfg"], lm["packed"], lm["prompt"]
    layers, steps = cfg.n_layers, 64
    bf16, f32 = torch.bfloat16, torch.float32
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp,
               fa.flash_attention, fd.flash_attention_decode)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    toks = generate(packed, prompt, cfg, steps, compute_dtype=bf16, use_flash=True)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"generate(use_flash=True): launches {launches}")
    check(toks.shape == (1, steps) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, "flash generate tokens shape / range")
    check(launches["flash_attention"] == layers, "B9 once per layer in the prefill")
    check(launches["flash_attention_decode"] == layers * steps, "B4 once per layer per step")
    check(launches["fused_norm_qkv"] == layers * steps, "B3 once per layer per step")
    check(launches["fused_block_tail"] == layers * steps, "B5 once per layer per step")
    check(launches["fused_mlp"] == layers, "B6 once per layer in the prefill")
    check(launches["packed_spmm"] == 6 * layers + 1 + steps, "B1 as without flash")

    # teacher-forced logits against the plain path, bounded as in phase 8;
    # the spread is the unfused plain path's (no kernel at all) distance
    for cdt, tol in ((bf16, 2.0 ** -7), (f32, 1e-4)):
        ids = toks if cdt == bf16 else generate(packed, prompt, cfg, steps,
                                                compute_dtype=cdt, use_flash=True)
        kern = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True, True)
        with plain_kernels():
            plain = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True, True)
            unfused = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, False, True)
        check(bool(torch.isfinite(kern).all()), "flash LM logits finite")
        check(torch.equal(kern.argmax(-1), ids[0]),
              "teacher-forced flash path reproduces generate's tokens")
        scale = plain.abs().amax(-1).clamp_min(1.0)
        err = (kern - plain).abs().amax(-1) / scale
        spread = (unfused - plain).abs().amax(-1) / scale
        med, worst = float(err.median()), float(err.max())
        check(med <= tol, f"flash LM {cdt}: median step error {med:.3e} > {tol:.3e}")
        check(worst <= max(tol, float(spread.max())),
              f"flash LM {cdt}: worst step error {worst:.3e} beyond {tol:.3e} and the "
              f"plain orders' spread {float(spread.max()):.3e}")
        log(f"flash LM {cdt} logits vs plain over {steps} steps: median {med:.2e}, "
            f"worst {worst:.2e} (spread {float(spread.max()):.2e}, tolerance {tol:.1e})")

    # chunked prefill (B3, B4's chunk entry and B5 at M=8) against lm_prefill
    def prefill(fn, *a, **kw):
        cache = lm_init_cache(cfg, 1, dtype=f32, device=dev)
        return fn(packed, prompt, cache, cfg, *a, compute_dtype=f32, **kw)[0].float()

    before = fd.flash_attention_decode.launches
    chunked = prefill(lm_prefill_chunked, 8, use_flash=True)
    check(fd.flash_attention_decode.launches == before + layers * prompt.shape[1] // 8,
          "lm_prefill_chunked runs B4's chunk entry once per layer per chunk")
    whole = prefill(lm_prefill, use_flash=True)
    with plain_kernels():
        unfused = prefill(lm_prefill, use_kernel=False, use_flash=True)
    scale = max(1.0, float(whole.abs().max()))
    err, spread = float((chunked - whole).abs().max()) / scale, \
        float((unfused - whole).abs().max()) / scale
    check(torch.equal(chunked.argmax(-1), whole.argmax(-1)), "chunked prefill argmax")
    check(err <= max(1e-4, spread), f"chunked prefill vs lm_prefill: {err:.3e} beyond "
          f"1e-4 and the plain orders' spread {spread:.3e}")
    log(f"lm_prefill_chunked(8, flash) vs lm_prefill, f32: {err:.2e} of max|logits| "
        f"(spread {spread:.2e})")

    # block_extend with C=4 against four decode steps: bitwise per row
    bcfg, blk = cfg.block, packed["blocks"][0]
    x = rng.rand_dense(rng.make_generator(17, dev), (1, 36, cfg.d_model))
    kw = dict(compute_dtype=f32, use_flash=True)
    c1 = init_block_cache(bcfg, 1, cfg.max_len, dtype=f32, device=dev)
    _, c1 = block_prefill(blk, x[:, :32], c1, bcfg, **kw)
    c2 = {**c1, "k": c1["k"].clone(), "v": c1["v"].clone()}
    ext, c1 = block_extend(blk, x[:, 32:], c1, bcfg, **kw)
    for i in range(4):
        step, c2 = block_decode_step(blk, x[:, 32 + i:33 + i], c2, bcfg, **kw)
        torch.cuda.synchronize()
        check(torch.equal(ext[:, i], step[:, 0]), f"block_extend row {i} != decode step")
    check(torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"]),
          "block_extend and the decode steps write the same cache")
    log("block_extend (C=4, flash, f32) equals four block_decode_steps bitwise per row")

    out = {"launches": launches}
    runs = {}
    for flash in (False, True, True, False):  # alternating: the host's load drifts
        r = run_lm_bench(cfg, 1, prompt.shape[1], steps, reps=3, device=dev,
                         use_flash=flash)
        runs.setdefault(flash, []).append(r.per_token_s * 1e6)
    for flash in (False, True):
        d = run_decode_bench(device=dev, use_flash=flash)
        args = parser().parse_args(["--flash"] if flash else [])
        tr = report(lm_decode_step_fn(args), {"call": "lm_decode_step", "flash": flash,
                                              "pos": args.prompt_len})
        row = {"flash": flash, "lm_us_per_token": runs[flash],
               "decode_step_us": d.step_s * 1e6, "decode_frac_roofline": d.frac_roofline,
               "decode_prefill_us": d.prefill_s * 1e6, "trace_launches": tr["launches"],
               "trace_call_us": tr["call_us"], "trace_kernel_us": tr["kernel_us"],
               "trace_busy_share": tr["busy_share"]}
        print(json.dumps(row), flush=True)
        out[flash] = row
    log(f"phase 12 passed: flash step {out[True]['trace_launches']:.0f} launches, busy "
        f"{out[True]['trace_busy_share']:.3f} (without flash "
        f"{out[False]['trace_launches']:.0f}, {out[False]['trace_busy_share']:.3f})")
    return out


def time_flash_kernels(torch, dev, spec, errs, flash) -> list:
    """Phase 13: B4 and B9 at the path shapes and one long shape each."""
    import torch.nn.functional as F

    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.roofline import roofline_bound
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.utils import rng

    gen = rng.make_generator(23, dev)
    bf16, f32 = torch.bfloat16, torch.float32
    rows, summary = [], []

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # B4: bf16 cache and compute, q in f32 as B3 gives it
    for label, b, h, kvh, s, pos in (("lm path", 1, 8, 8, 224, 95),
                                     ("long", 1, 8, 8, 8192, 8191)):
        q, kc, vc = _decode_inputs(torch, gen, b, 1, h, kvh, s, bf16)
        q = q[:, 0]
        kw = dict(compute_dtype=bf16)
        t_k = measure(lambda: fd.flash_attention_decode(q, kc, vc, pos, **kw))
        t_p = measure(lambda: fd.flash_attention_decode_plain(q, kc, vc, pos, **kw))
        live = pos + 1
        kl = kc[:, :live].view(b, live, kvh, 128).transpose(1, 2)
        vl = vc[:, :live].view(b, live, kvh, 128).transpose(1, 2)
        qb = q.to(bf16)[:, :, None]
        gqa = {"enable_gqa": True} if kvh < h else {}
        t_l = measure(lambda: F.scaled_dot_product_attention(qb, kl, vl, **gqa))
        out = fd.flash_attention_decode(q, kc, vc, pos, **kw)
        n_bytes = nbytes(q, kl, vl, out)
        bound, by = roofline_bound(4.0 * b * h * live * 128, n_bytes, spec, "bf16")
        rows.append({"kernel": "B4 flash_attention_decode", "shape": label,
                     "B": b, "H": h, "KVH": kvh, "S": s, "pos": pos, "ms": t_k.min_s * 1e3,
                     "mean_ms": t_k.mean_s * 1e3, "plain_ms": t_p.min_s * 1e3,
                     "bound_ms": bound * 1e3, "bound_by": by, "bytes": n_bytes,
                     "library_ms": t_l.min_s * 1e3})
    # B9: the path's prefill in f32 (its projections are f32), the long in bf16
    for label, b, h, t, dt in (("lm prefill", 1, 8, 32, f32), ("long", 1, 8, 4096, bf16)):
        q = (rng.rand_dense(gen, (b, h, t, 128)) * 4.0).to(dt)
        k = rng.rand_dense(gen, (b, h, t, 128), dtype=dt)
        v = rng.rand_dense(gen, (b, h, t, 128), dtype=dt)
        t_k = measure(lambda: fa.flash_attention(q, k, v))
        t_p = measure(lambda: fa.flash_attention_plain(q, k, v))
        t_l = measure(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        n_bytes = 2 * nbytes(q) + nbytes(k, v)
        ops = 4.0 * b * h * 128 * t * (t + 1) / 2
        bound, by = roofline_bound(ops, n_bytes, spec, "f32" if dt == f32 else "bf16")
        rows.append({"kernel": "B9 flash_attention", "shape": label, "B": b, "H": h,
                     "T": t, "dtype": str(dt), "ms": t_k.min_s * 1e3,
                     "mean_ms": t_k.mean_s * 1e3, "plain_ms": t_p.min_s * 1e3,
                     "bound_ms": bound * 1e3, "bound_by": by, "bytes": n_bytes,
                     "ops": ops, "library_ms": t_l.min_s * 1e3})
    for r in rows:
        print(json.dumps({**r, "library": "torch.nn.functional.scaled_dot_product_attention"}),
              flush=True)
    for name, src, line, row in (
            ("flash_attention_decode", "flash_decode", "flash_decode.py:412", rows[0]),
            ("flash_attention", "flash_attention", "flash_attention.py:662", rows[2])):
        summary.append({
            "name": name, "route": "cuda",
            "source": f"smmb_tpu_torch/kernels/csrc/{src}.cu",
            "replaces": f"smmb_tpu/kernels/{line}",
            "launches": flash["launches"][name], "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    log("phase 13 passed: B4 and B9 timed at the path and long shapes")
    return summary


if __name__ == "__main__":
    sys.exit(main())
